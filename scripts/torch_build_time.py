"""Wall time of building the PyTorch/CUDA port's kernels from a csrc tree.

    python3 scripts/torch_build_time.py [--csrc DIR] [--out DIR]

Compiles every ``*.cu`` of DIR (default: ``mppi_generic_tpu_torch/csrc``)
with the flags of ``mppi_generic_tpu_torch/ops/_build.py``, one ``nvcc`` per
source, all started together, into a fresh directory under OUT (default
``build/build_time``), and prints one JSON line: the wall seconds of the
whole build, each source's seconds, and the card's name and power limit.
Needs nvcc; nothing is loaded or run. To compare two trees, run it on both
in one call, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mppi_generic_tpu_torch.ops import _build  # noqa: E402


def build_seconds(csrc: Path, out_root: Path) -> dict:
    out_root.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(dir=out_root))
    sources = sorted(csrc.glob("*.cu"))
    t0 = time.perf_counter()
    procs = {src.stem: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
         str(out / f"lib{src.stem}.so"), str(src)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for src in sources}
    per_source = {}
    while len(per_source) < len(procs):  # each source's seconds to its exit
        for name, proc in procs.items():
            if name not in per_source and proc.poll() is not None:
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode})")
                per_source[name] = time.perf_counter() - t0
        time.sleep(0.05)
    wall = time.perf_counter() - t0
    shutil.rmtree(out)
    return {"csrc": str(csrc), "sources": len(sources), "wall_s": wall,
            "per_source_s": per_source}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "build_time")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(json.dumps({"build": build_seconds(args.csrc.resolve(), args.out),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
