"""What NCCL itself does with two ranks on one GPU: two processes join one
NCCL group (plain `torch.distributed`, not the port's `init_distributed`,
which refuses this before NCCL is reached), both on cuda:0, and run one
all_reduce. Prints each rank's outcome (the result, or the error's last
lines); each rank is killed after 120 s.

    python3 tools/torch_nccl_shared_device.py
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import subprocess
import traceback

TIMEOUT_S = 120


def _rank(rank: int, port: int, out) -> None:
    try:
        import datetime

        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        out.put((rank, f"all_reduce returned {t.tolist()}"))
        dist.destroy_process_group()
    except BaseException as e:  # report what NCCL raised, whatever it is
        lines = traceback.format_exception_only(type(e), e)
        out.put((rank, "".join(lines).strip()[-1500:]))


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    seen = {}
    try:
        while len(seen) < 2:
            rank, msg = out.get(timeout=TIMEOUT_S)
            seen[rank] = msg
    except queue.Empty:
        pass
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)
    for r in range(2):
        print(f"rank {r}: {seen.get(r, f'no outcome within {TIMEOUT_S}s (killed)')}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
