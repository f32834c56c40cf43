"""The SASS of this tree's kernel libraries against another checkout's (a
parent commit unpacked with `git archive <commit> | tar -x -C DIR` into a
directory that .gitignore lists, such as .chip_trial/): every
instantiation that the other checkout's library holds must be in this
one, instruction for instruction.

Both libraries are built with nvcc from their own csrc/ (kernels/build.py,
the other one under build/sass_compare/) and listed with cuobjdump -sass.
A function is matched by its kernel and template arguments
(sass_audit.demangle), which sets aside the anonymous namespace's name: it
carries a hash of the source's path, which differs between two trees. A
kernel that gained template arguments at the end (APPENDED: K7's PF, the
next-pop prefetch) matches the other tree's instantiation with those
arguments at their old meaning (PF 0). Each matched pair's instructions
are compared as text, the namespace's name set aside; instantiations only
this tree has are counted by kernel.

Usage: python -m rodent_tpu_torch.experiments.sass_compare --against DIR
    [--kinds main,ct]
Needs nvcc and cuobjdump (the card's machine); exits 1 where an
instantiation differs or is missing.
"""
from __future__ import annotations

import argparse
import re
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..kernels import build
from . import common, sass_audit

# kernel -> the template arguments it gained at the end, at the value that
# keeps its old meaning
APPENDED = {"bvh_ct_kernel": (0,)}
OTHER_DIR = build.BUILD_DIR.parent / "sass_compare"
_NAMESPACE = re.compile(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+")


def instructions(fn):
    """A function's instruction texts, the anonymous namespace's name set
    aside."""
    return [_NAMESPACE.sub("_GLOBAL__N_", text) for _, text, _ in fn.insns]


def compare(mine, other):
    """{"other", "mine" (instantiations of sass_audit's kernels in each),
    "equal", "differ", "missing" (the other's that this tree lacks, by
    name), "added" (Counter of this tree's new instantiations by kernel)}
    of two {function: common.Sass} listings."""
    def keyed(listing):
        out = {}
        for name, fn in listing.items():
            key = sass_audit.demangle(name)
            if key is not None:
                out[key] = (name, fn)
        return out
    a, b = keyed(mine), keyed(other)
    res = {"other": len(b), "mine": len(a), "equal": 0, "differ": [],
           "missing": [], "added": Counter()}
    matched = set()
    for (kernel, targs), (name, fn) in sorted(b.items()):
        key = (kernel, targs)
        if key not in a:
            key = (kernel, targs + APPENDED.get(kernel, ()))
        if key not in a:
            res["missing"].append(name)
            continue
        matched.add(key)
        if instructions(a[key][1]) == instructions(fn):
            res["equal"] += 1
        else:
            res["differ"].append(name)
    for key in a:
        if key not in matched:
            res["added"][key[0]] += 1
    return res


def run(against, kinds=("main", "ct")):
    """Builds each library of `kinds` from this tree and from the checkout
    at `against`, compares them and prints a line each; returns {kind:
    compare's result}."""
    csrc = Path(against) / "rodent_tpu_torch" / "csrc"
    if not csrc.is_dir():
        raise SystemExit(f"sass_compare: no rodent_tpu_torch/csrc under "
                         f"{against}")
    with ThreadPoolExecutor(2 * len(kinds)) as pool:
        mine = {k: pool.submit(build.build, None, k) for k in kinds}
        other = {k: pool.submit(build.build, OTHER_DIR, k, (), csrc)
                 for k in kinds}
        paths = {k: (mine[k].result()[0], other[k].result()[0])
                 for k in kinds}
    out = {}
    for kind, (a, b) in paths.items():
        r = compare(common.read_sass(a), common.read_sass(b))
        out[kind] = r
        added = ", ".join(f"{k} {v}" for k, v in sorted(r["added"].items()))
        print(f"{kind}: {r['other']} instantiations in {against}, "
              f"{r['mine']} here; {r['equal']} equal instruction for "
              f"instruction, {len(r['differ'])} differ, {len(r['missing'])} "
              f"missing; added here: {added or 'none'}", flush=True)
        for name in r["differ"] + r["missing"]:
            print(f"  {name}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="sass_compare")
    p.add_argument("--against", required=True,
                   help="the root of the other checkout")
    p.add_argument("--kinds", default="main,ct",
                   help="the libraries to compare (kernels/build.py)")
    args = p.parse_args(argv)
    kinds = tuple(args.kinds.split(","))
    for k in kinds:
        if k not in build.LIBRARIES:
            p.error(f"--kinds {k}: one of {', '.join(build.LIBRARIES)}")
    if build.find_nvcc() is None:
        p.error("needs nvcc and cuobjdump (the CUDA toolkit)")
    res = run(args.against, kinds)
    return 0 if all(not r["differ"] and not r["missing"]
                    for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
