"""The ``-Xptxas -v`` report (registers and spill bytes per kernel) of two
source trees side by side: every kernel of the first tree (the parent), its
line there and the line of the same instantiation in the second tree. Where
the second tree added a trailing ``bool`` template argument to a kernel (a
fleet's variant: ``kFleet`` or ``kBatched``; a particle shard's:
``kShard``), its ``false`` instantiation is the one compared, and its
``true`` one is shown beside it. A kernel that the second tree merged into
another as that one's trailing ``true`` (``MERGED``: a parent's
``fused_nl_cluster_kernel<...>`` is ``fused_nl_kernel<..., true>``, the
``kCluster`` build) is compared with that instantiation.

    git archive <parent commit> | tar -x -C _tree_check/parent
    python tools/ptxas_compare.py _tree_check/parent .

Each tree builds its kernels (``gpu_kernels.build()``: ``nvcc`` for
``sm_90a``, no card needed) in a process of its own (``--tree TREE``) that
prints its report as one JSON line. The comparison prints one line a
kernel, then the kernels only the second tree has, then the kernels whose
registers or spills differ, and exits 1 if any does.
"""
import json
import os
import re
import subprocess
import sys

# a parent's kernel -> the kernel whose trailing `true` it became
MERGED = {"fused_nl_cluster_kernel": "fused_nl_kernel"}


def report(text):
    """``-Xptxas -v`` output -> {kernel: [registers, spill stores, spill
    loads]}, the kernel named by its identifier and mangled template
    arguments (``gumbel_graphs_kernelILi4ELi0ELb0EE`` for ``<4, 0,
    false>``); the first report of a name is kept."""
    out, name, spill = {}, None, (0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"[a-z_]+[0-9]*_(?:kernel|merge|reference)"
                          r"(?:I\w*?EE)?", m.group(1))
            name, spill = (k.group(0) if k else m.group(1)), (0, 0)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, [int(m.group(1)), *spill])
            name = None
    return out


def tree_report(tree):
    sys.path.insert(0, os.path.abspath(tree))
    from dibs_tpu_torch.ops import gpu_kernels as gk

    assert gk.__file__.startswith(os.path.abspath(tree)), gk.__file__
    gk.build()
    print("REPORT " + json.dumps(report(gk.build_log())), flush=True)


def variant(name, flag):
    """``name`` with a trailing ``bool`` template argument ``flag``."""
    if name.endswith("EE"):
        return f"{name[:-1]}Lb{flag}EE"
    return f"{name}ILb{flag}EE"


def counterpart(name):
    """The second tree's names of the parent's kernel ``name``: the one
    compared and the one shown beside it (or ``None``)."""
    base, sep, args = name.partition("I")  # kernel names are lower case
    if base in MERGED:
        return variant(MERGED[base] + sep + args, 1), None
    return variant(name, 0), variant(name, 1)


def fmt(entry):
    if entry is None:
        return "-"
    regs, stores, loads = entry
    return f"{regs} reg, spill {stores}/{loads} B"


def main():
    parent, change = sys.argv[1:3]
    reps = []
    for tree in (parent, change):
        out = subprocess.run([sys.executable, __file__, "--tree", tree],
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("REPORT ")][-1]
        reps.append(json.loads(line[len("REPORT "):]))
    old, new = reps
    differ = []
    for name in sorted(old):
        compared, beside = counterpart(name)
        single = new.get(compared, new.get(name))
        added = new.get(beside)
        same = single == old[name]
        if not same:
            differ.append(name)
        print(f"{name}: parent {fmt(old[name])}; change {fmt(single)}"
              f"{'' if same else ' (DIFFERS)'}; added variant {fmt(added)}")
    seen = {n for name in old for n in (name, *counterpart(name))}
    for name in sorted(set(new) - seen):
        print(f"{name}: new in the change {fmt(new[name])}")
    print(f"kernels {len(old)}, differing from the parent: {len(differ)} "
          f"{differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    if sys.argv[1] == "--tree":
        tree_report(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
