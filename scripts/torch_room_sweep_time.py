"""Time the room sweep on the card (ops/room_sweep.py) against the numpy
sweep it replaces, at the room benchmark's largest room.

    python scripts/torch_room_sweep_time.py [--reps 20]

The room is the room benchmark's conference room as its generator builds
it (chip_smoke.py::surface_room, which benchmark/harness/traffic.py
copies: 8 x 6 x 3 m, 10,600 points a square metre of surface: floor,
ceiling, four walls, a table, a bookcase face, clutter; 1,536,576 float64
rows), written once as .npy. Prints, each the median of ``--reps``:

- the numpy path, ``load_room(i)``: its read and its sweep (host clock);
- the device path, ``load_room(i, device="cuda")``, to the blocks on the
  card (host clock around a synchronise), and its read alone;
- the kernels' device time (CUDA events over ``--reps`` calls):
  ``block_members`` (4 launches) and ``gather_blocks`` (48 x 4096), their
  plain versions on the same CUDA tensors, and each kernel's time by name
  from one profiled call of both;
- each kernel's bound: its bytes read and written once at 3.35 TB/s;
- the card's name and power limit.

Checks that both paths give the same blocks. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    SWEEP_PER_M2,
    SWEEP_POINTS,
    SWEEP_ROOM,
    surface_room,
)
from weaksuppointcloudseg_tpu_torch.data import s3dis  # noqa: E402
from weaksuppointcloudseg_tpu_torch.ops import room_sweep  # noqa: E402

HBM_BYTES_PER_S = 3.35e12


def host_ms(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def device_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def by_kernel(fns):
    """Device ms by kernel name of one call of each of ``fns``, profiled
    together."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    return {e.key: round(e.device_time_total / 1e3, 4)
            for e in prof.key_averages() if e.device_time_total > 0}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    room = surface_room(np.random.default_rng(0), SWEEP_ROOM, SWEEP_PER_M2)
    out = {"card": card, "points": len(room), "reps": args.reps}
    with tempfile.TemporaryDirectory() as base:
        os.makedirs(os.path.join(base, "meta"))
        os.makedirs(os.path.join(base, "rooms"))
        np.save(os.path.join(base, "rooms", "r.npy"), room)
        with open(os.path.join(base, "meta", "a_data_label.txt"), "w") as f:
            f.write("rooms/r.npy\n")
        rooms = s3dis.S3DISTestRooms(base, "a", num_point=SWEEP_POINTS)
        want = rooms.load_room(0, rng=np.random.default_rng(1))
        got = rooms.load_room(0, rng=np.random.default_rng(1), device="cuda")
        assert torch.equal(got[0].cpu(), torch.from_numpy(want[0]))
        assert torch.equal(got[1].cpu(), torch.from_numpy(want[1]))
        rng = np.random.default_rng(2)
        path = rooms.room_paths[0]
        out["numpy_read_ms"] = host_ms(lambda: np.load(path), args.reps)
        out["numpy_sweep_ms"] = host_ms(
            lambda: s3dis._sweep(room, SWEEP_POINTS, s3dis.MIN_POINTS, rng), args.reps)
        buf = rooms._bufs[0]
        out["device_read_ms"] = host_ms(lambda: s3dis.read_room(path, buf), args.reps)
        out["device_load_room_ms"] = host_ms(
            lambda: rooms.load_room(0, rng=rng, device="cuda"), args.reps)

    raw = torch.from_numpy(room).cuda()
    limit = room[:, 0:3].max(0)
    num_x, num_y = s3dis._grid(limit)
    members, counts = room_sweep.block_members(raw, num_x, num_y)
    m = int(counts.sum())
    picks = s3dis._draws(counts.cpu().numpy(), SWEEP_POINTS, s3dis.MIN_POINTS, rng,
                         lambda shape: np.empty(shape, np.int32))
    picks = torch.from_numpy(picks).cuda()
    k = len(picks)
    kernels = {
        "block_members": lambda: room_sweep.block_members(raw, num_x, num_y),
        "block_members_ref": lambda: room_sweep.block_members_ref(raw, num_x, num_y),
        "gather_blocks": lambda: room_sweep.gather_blocks(raw, members[:m], picks, limit),
        "gather_blocks_ref": lambda: room_sweep.gather_blocks_ref(raw, members[:m], picks,
                                                                  limit),
    }
    for name, fn in kernels.items():
        out[f"{name}_ms"] = device_ms(fn, args.reps)
    out["by_kernel_ms"] = by_kernel([kernels["block_members"],
                                     kernels["gather_blocks"]])
    # bytes read and written once: x and y of every row, the members; the
    # picked rows, their picks and members, the blocks and labels
    n, c = raw.shape
    bucket_bytes = 16 * n + 4 * m
    gather_bytes = k * SWEEP_POINTS * (8 * c + 4 + 4 + 9 * 4 + 4)
    out.update(members=m, blocks=k, bucket_bytes=bucket_bytes,
               gather_bytes=gather_bytes,
               block_members_bound_ms=bucket_bytes / HBM_BYTES_PER_S * 1e3,
               gather_blocks_bound_ms=gather_bytes / HBM_BYTES_PER_S * 1e3)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
