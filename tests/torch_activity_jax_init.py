"""JAX's initial weights of the activity classifier, as the leaves
snsde_torch.convert loads (run_activity's `init=`): the model JAX's
run_activity draws at a seed (snsde/harness/activity.py:143-147:
PRNGKey(seed), the second half of its first split).

Run as a script, it writes goldens/activity_jax_init.npz beside it: seeds
0-4 at the activity flagship's setting (synthetic person activity: 12
channels, 50 reference times, 7 classes; latent 32, rec_hidden 32,
embed_time 128, one head, a learned time embedding), each leaf under
"seed<k>/<leaf key>", which `python3 chip_smoke.py --activity-jax-init`
trains from on a machine without JAX:

    JAX_PLATFORMS=cpu python tests/torch_activity_jax_init.py

Not collected as a test module: it imports the JAX package."""

import os
import sys

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from snsde.harness import activity as jact  # noqa: E402

SEEDS = (0, 1, 2, 3, 4)
# the flagship's model (chip_smoke.py's ACTIVITY_R5 over run_activity's
# defaults) on synthetic_person_activity's data
FLAGSHIP = dict(D=12, L=50, latent_dim=32, rec_hidden=32, embed_time=128,
                num_heads=1, classes=7, learn_emb=True)
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                   "activity_jax_init.npz")


def jax_arrays(tree):
    """JAX leaves keyed by dotted attribute/index path, the key format of
    snsde_torch.convert."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [k.name if isinstance(k, jax.tree_util.GetAttrKey)
                 else str(k.idx) for k in path
                 if not isinstance(k, jax.tree_util.FlattenedIndexKey)]
        out[".".join(parts)] = np.asarray(leaf)
    return out


def initial_leaves(seed, D, L, latent_dim, rec_hidden, embed_time,
                   num_heads, classes, learn_emb):
    """The leaves of the model JAX's run_activity trains from at `seed`."""
    _, km = jax.random.split(jax.random.PRNGKey(seed))
    query = np.linspace(0.0, 1.0, L, dtype=np.float32)
    return jax_arrays(jact._ActivityModel.create(
        km, D, query, latent_dim, rec_hidden, embed_time, num_heads,
        classes, learn_emb))


def main(out=OUT):
    arrays = {f"seed{s}/{k}": v.astype(np.float32)
              for s in SEEDS for k, v in initial_leaves(s, **FLAGSHIP).items()}
    np.savez_compressed(out, **arrays)
    print(f"wrote {out}: {len(arrays)} arrays, seeds {SEEDS}")


if __name__ == "__main__":
    main()
