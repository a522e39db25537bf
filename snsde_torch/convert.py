"""Weights carried across from the JAX package, and gradients back.

The JAX package's models are pytrees; a caller flattens one into numpy
arrays keyed by the dotted path of each leaf (attribute names and tuple
indices, e.g. `sde.func.linear_in.weight`, `sde.func.noise_t.1.bias`,
`sde.readout.norm.running_var` — a BatchNorm buffer is keyed without its
`.value`; for the robustness classifier `layer.inner.func.linears.0.weight`,
`layer.inner.initial_network.bias`, `norm.scale`, `fc2.weight`: a JAX tuple
of Linears is a `ModuleList` here, with the same indices; for the recurrent
classifiers `layer.inner.cells.0.w_ih` and `layer.inner.cells_bwd.0.b_hh`
(SeqRNN's cells, a `ModuleList` of cells), `layer.inner.embed.weight`, and
GRUDFull's own `layer.inner.w_hh`, `layer.inner.gamma_x.weight` and
`layer.inner.x_mean`; for the ODE-RNN hybrids `layer.inner.gru.w_ih` and
`layer.inner.linear.weight` (GRUdt, GRUD, ODERNN), GRUD's
`layer.inner.decay.weight`, ODERNN's `layer.inner.f_layers.1.bias` (its
tuple of Linears a `ModuleList` here), ODELSTM's `layer.inner.lstm.w_hh`
and `layer.inner.f1.weight`, and the layer's own `layer.in_proj.weight`;
for the time-aware LSTMs each cell of `layer.inner.cells.0...`: TLSTM's
Linears `W_all`, `U_all`, `W_d`, PLSTM's raw `W`, `U`, `bias`, `periods`,
`shifts`, `on_end`, TGLSTM's Linears `weights` and `weight_t`; SeqCNN's
`layer.inner.kernels.0` (raw [k, c_in, c_out], a `ParameterList` here)
and `biases.0`; SeqTransformer's `layer.inner.wq.0.weight` .. `ff2.1.bias`
and `embed`;
for the model zoo mTAN's reference grid `layer.inner.enc.query` (a raw
leaf, a trained parameter on both sides), SAnD's tuple of blocks
`layer.inner.blocks.0.attn.wq.weight` with its LayerNorms' raw `gamma`
and `beta`, MIAM's `layer.inner.encoder.obs_block.layers.1.norm_q.alpha`
(each encoding block's tuple of layers; the norms' raw `alpha`, `bias`),
its `decoder.weight` (no bias), raw `decoder_bias` and head BatchNorm
`clf_norm.scale`/`running_var`, the flows' `flow_layers.0.time_net.lin.
weight` and `mlp_layers.0.bias` (tuples of modules or Linears), ANCDE's
`func_g.linear_out.weight`, EXIT's `ode_f1.weight` and LEAP's
`mapping2.bias`;
for the interpolation harness's VAE its recognition network
`rec.sde.func.linear_in.weight`, `rec.sde.initial_network.bias`, the
stream's unused `rec.sde.linear.weight` and `rec.head.weight`, and its
decoder `dec.gru_f.w_ih`, `dec.query`, `dec.out1.weight` (DecRNN3), with
MTANDecoder's `dec.att.wq.weight` and `dec.time_emb.periodic.weight`; for
the activity harness's classifier `rec.att.wo.weight`, `rec.gru_b.b_hh`,
`rec.query` and `fc1.weight`-`fc3.bias`;
for the seed ensembles the members' tuples, a
`ModuleList` here too: InitialValueSeedEnsemble's
`members.0.field.linear_in.weight` and `members.0.readout.norm.running_var`,
SeedEnsemble's `fields.0...`, `initial_networks.0...` and `readouts.0...`,
ISTSSeedEnsembleSDE's `members.0.layer.inner.func...`);
for the tutorial path the `MLP`'s tuple of Linears, a `ModuleList` here
(`layers.0.weight`), the tutorial fields' `linear_X`, `emb`,
`f_net.layers.1.bias`, `noise_in` and `g_net`, and `NDEModel`'s
`func.g_net.layers.2.weight`, `initial.bias` and `decoder.weight`; for
`make_model`'s baseline twins NeuralCDE's `func.linear_out.weight`
(`func.W_r.weight` for `gruode`), `initial_network.bias` and
`readout.norm.scale`, and GRUdt's, GRUD's and ODERNN's `gru.w_ih`,
`decay.weight` and `f_layers.0.bias` at the top level. A cell's or GRUDFull's raw arrays (`w_ih`, `w_hh`,
`b_ih`, `b_hh`, `x_mean`) have one layout on both sides and are copied as
they are; only a `Linear`'s weight is transposed.
`load_jax_arrays` fills a port model from such a dict;
`grads_to_jax_layout` returns the port's gradients under the same keys and
in the JAX layout, so tests compare the two packages leaf by leaf. The port
never sees a JAX object.

The layouts differ in three ways, all handled here:
  * a JAX `Linear` weight is [in, out], torch's is [out, in];
  * the JAX field keeps its noise nets as tuples of Linears, the port keeps
    the reference's modules: a lone `Linear`, or `Sequential(Linear, ReLU,
    Linear)` whose Linears sit at indices 0 and 2;
  * JAX `BatchNorm.scale`/`offset` are torch's `weight`/`bias`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_jax_arrays", "grads_to_jax_layout"]

_TUPLE_FIELDS = ("noise_t", "noise_y")


def _name_map(model: nn.Module) -> Dict[str, Tuple[str, bool]]:
    """port state_dict name -> (JAX leaf name, transpose?)."""
    out = {}
    for pname in model.state_dict():
        if pname.endswith("num_batches_tracked"):     # torch-only counter
            continue
        parts = pname.split(".")
        mod, jparts = model, []
        for p in parts[:-1]:
            child = mod[int(p)] if p.isdigit() else getattr(mod, p)
            if isinstance(mod, nn.Sequential):
                # the j-th Linear of the Sequential is tuple element j
                jparts.append(str(sum(isinstance(m, nn.Linear)
                                      for m in list(mod)[:int(p)])))
            else:
                jparts.append(p)
            if p in _TUPLE_FIELDS and isinstance(child, nn.Linear):
                jparts.append("0")                    # a 1-tuple in JAX
            mod = child
        leaf = parts[-1]
        if isinstance(mod, nn.BatchNorm1d):
            leaf = {"weight": "scale", "bias": "offset"}.get(leaf, leaf)
        out[pname] = (".".join(jparts + [leaf]),
                      isinstance(mod, nn.Linear) and leaf == "weight")
    return out


def load_jax_arrays(model: nn.Module, arrays: Dict[str, np.ndarray]) -> None:
    """Fill `model`'s parameters and buffers from the JAX model's leaves.
    Raises KeyError on any missing or extra key, ValueError on a shape
    mismatch."""
    by_jax = {j: (p, tr) for p, (j, tr) in _name_map(model).items()}
    missing = sorted(set(by_jax) - set(arrays))
    extra = sorted(set(arrays) - set(by_jax))
    if missing or extra:
        raise KeyError(f"JAX arrays do not match the model: missing "
                       f"{missing}, extra {extra}")
    state = model.state_dict()
    with torch.no_grad():
        for j, (p, tr) in by_jax.items():
            v = torch.as_tensor(np.array(arrays[j]))
            if tr:
                v = v.T
            if tuple(v.shape) != tuple(state[p].shape):
                raise ValueError(f"{j}: shape {tuple(v.shape)} does not fit "
                                 f"{p} {tuple(state[p].shape)}")
            state[p].copy_(v)


def grads_to_jax_layout(model: nn.Module) -> Dict[str, np.ndarray]:
    """The gradient of every parameter, keyed and laid out as the JAX
    model's leaves; a parameter without a gradient gives zeros (the JAX
    gradient of an unused leaf)."""
    params = dict(model.named_parameters())
    out = {}
    for p, (j, tr) in _name_map(model).items():
        if p not in params:                           # a buffer
            continue
        g = params[p].grad
        g = (torch.zeros_like(params[p]) if g is None else g).detach()
        g = g.cpu().numpy()
        out[j] = g.T if tr else g
    return out
