"""Time gloo all_reduces of CUDA tensors between ranks of one card.

    python3 scripts/allreduce_calibration.py

Run from the root of a checkout on a machine with a CUDA card.  It
spawns worlds of 2 and 4 ranks on the card (``repro_torch.parallel
.run_ranks``; several ranks of one card take gloo, since NCCL refuses
two ranks on one GPU) and prints, per rank, the mean ms of an
all_reduce of 1,000 floats (4 KB) and of a (2^20, 10) float panel
(41.9 MB, the sharded paths' panel at n = 2^20), over 5 calls after
one warm-up, host clock around a synchronize.  The card's name and
power limit come first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PANEL = (1 << 20) * 10
REPS = 5


def all_reduce_rank(dev) -> dict:
    import torch
    import torch.distributed as dist

    from repro_torch import parallel

    group = parallel.edge_group(parallel.default_edge_mesh(device=dev))
    out = {}
    for numel in (1000, PANEL):
        x = torch.ones(numel, device=dev)
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        out[numel * 4] = (time.perf_counter() - t0) / REPS * 1e3
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import parallel

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for world in (2, 4):
        for r, res in enumerate(parallel.run_ranks(world, all_reduce_rank)):
            print(f"ranks {world} rank {r} ms by bytes {res.value}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
