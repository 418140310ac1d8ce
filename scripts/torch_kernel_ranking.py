"""Rank the port's kernels by launches x (time - bound) on the default route.

Reads the ``kernels`` line that ``chip_smoke.py`` prints (from a file that
holds its output) and, for every entry, counts the launches of the loops
that run the kernel on their configuration's default route: a loop that
reaches a split entry only by forcing the split form, or a combined B1 or B3
only by forcing the combined kernel, against ``AUTO_SPLIT``
(``ops/fused_rollout.py``; the entry's ``forced_by_path``, from
``_build.forced_routes``) does not count for it. Prints one JSON line per
entry, the largest loss first: its launches on the default route, its time
and bound (ms) and their product with the difference, the ms a run of those
loops loses to the bound:

    python3 scripts/torch_kernel_ranking.py chip_smoke_output.txt
"""

import json
import sys


def forced_away(entry, path):
    """Whether the loop ``path`` runs the kernel ``entry`` (a kernels-line
    entry) only because it forces a form against AUTO."""
    forced = entry.get("forced_by_path", {}).get(path, ())
    # the combined kernels, and the epilogue passes after the warp forms of
    # B3 and B1
    if "combined" in forced and entry["name"].startswith(("rollout_costs", "fused_solve",
                                                          "block_carry", "block_min")):
        return True
    return "split" in forced and entry["name"].startswith("split_")


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    kernels = None
    with open(argv[1]) as f:
        for line in f:
            if line.startswith('{"kernels"'):
                kernels = json.loads(line)["kernels"]
    if kernels is None:
        print(f"no kernels line in {argv[1]}", file=sys.stderr)
        return 1
    rows = []
    for k in kernels:
        by = {p: n for p, n in k.get("launches_by_path", {}).items()
              if n and not forced_away(k, p)}
        n = sum(by.values())
        rows.append({"name": k["name"], "launches": n, "ms": k["ms"], "bound_ms": k["bound_ms"],
                     "loss_ms": n * (k["ms"] - k["bound_ms"]), "paths": by})
    for r in sorted(rows, key=lambda r: -r["loss_ms"]):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
