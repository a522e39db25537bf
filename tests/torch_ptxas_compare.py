"""Compare the ptxas reports of a CUDA source's fp32 instances between two
builds: each kernel's registers, stack frame and spills, matched by its
demangled name and template arguments.

    python3 tests/torch_ptxas_compare.py PARENT_REPORT CHILD_REPORT

A report is nvcc's output for one source built with `-Xptxas -v`, as
`snsde_torch/kernels/_build.py` keeps it (`BUILD_LOG[name]["log"]`), for
example written out on the card after `_build.build(["fused_rnn"])` in each
tree. The child's instances whose last template argument is `true` (the
reduced precisions' `RED` instances) have no parent counterpart and are
counted apart; a last argument `false` is dropped before matching, so
`lstm_bwd_kernel<1, 0, 4, false>` is compared with the parent's
`lstm_bwd_kernel<1, 0, 4>`. The parameter lists are not compared (a
reduced instance's source adds a `Prec` parameter to every entry). Prints
the counts and every instance found in only one report or differing;
exits 1 if any fp32 instance is missing or differs.

This script runs no kernel and needs no card: ptxas's reports come from a
build on the card.
"""

import re
import subprocess
import sys


def parse(path):
    """{demangled entry name: (registers, stack, spill stores, spill
    loads)} of one report."""
    props, cur = {}, None
    for line in open(path):
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            props[cur] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if m.group(1) in props else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props[cur]["spill"] = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            props[cur]["regs"] = int(m.group(1))
    names = list(props)
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True,
                         check=True).stdout.split("\n")
    return {d: (props[n].get("regs"),) + props[n].get("spill", (None,) * 3)
            for n, d in zip(names, out)}


def key(demangled):
    """The kernel's name and template arguments, without the anonymous
    namespace, the return type and the parameters."""
    name = demangled.replace("(anonymous namespace)::", "").split("(")[0]
    return re.sub(r"^void ", "", name)


def compare(parent_path, child_path):
    parent = {}
    for d, v in parse(parent_path).items():
        if key(d) in parent:
            raise SystemExit(f"two parent entries share {key(d)}")
        parent[key(d)] = v
    child = parse(child_path)
    red, fp32, other = [], {}, []
    for d, v in child.items():
        k = key(d)
        if k.endswith(", true>"):
            red.append(k)
        elif k.endswith(", false>"):
            fp32[k[:-len(", false>")] + ">"] = v
        else:
            fp32[k] = v
    missing = sorted(set(parent) - set(fp32))
    extra = sorted(set(fp32) - set(parent))
    differ = sorted(k for k in set(parent) & set(fp32) if parent[k] != fp32[k])
    print(f"parent entries {len(parent)}; child entries {len(child)}: fp32 "
          f"{len(fp32)}, RED {len(red)}; compared {len(set(parent) & set(fp32))}"
          f", differing {len(differ)}, parent's not in the child "
          f"{len(missing)}, child's fp32 not in the parent {len(extra)}")
    for k in differ:
        print(f"  differs: {k}: parent (regs, stack, spill st, spill ld) "
              f"{parent[k]}, child {fp32[k]}")
    for k in missing:
        print(f"  only in the parent: {k}")
    for k in extra:
        print(f"  only in the child (fp32): {k}")
    return 1 if differ or missing or extra else 0


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    sys.exit(compare(sys.argv[1], sys.argv[2]))
