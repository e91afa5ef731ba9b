"""Cells on several cards: one process a card, joined in one
torch.distributed group (NCCL on the cards, gloo on the CPU in the tests).

The harness's process is rank 0: it builds the kernel library, starts the
other ranks, and before every call broadcasts what to do next, so that all
ranks run the same calls with the same seeds. A worker builds the cell's
study on its card, warms it up, then follows rank 0's orders; at the end
it reports its launch counts a call, its peak memory and its profiled
busy time through a queue that rank 0 drains before it joins.
"""
from __future__ import annotations

import datetime
import socket

import torch

STOP, CALL, PROFILE = 0, 1, 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(rank: int, world: int, port: int, device) -> None:
    import torch.distributed as dist
    kw = dict(init_method=f"tcp://localhost:{port}", world_size=world,
              rank=rank, timeout=datetime.timedelta(minutes=5))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device, **kw)
    else:
        dist.init_process_group("gloo", **kw)


def order(op: int, seed: int = 0, count: int = 0, device=None) -> tuple:
    """Rank 0 sends (op, seed, count) to every rank (the others pass
    nothing and receive it)."""
    import torch.distributed as dist
    t = torch.tensor([op, seed >> 31, seed & (2 ** 31 - 1), count],
                     dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    op, hi, lo, count = (int(v) for v in t.tolist())
    return op, (hi << 31) | lo, count


class Ranks:
    """Ranks 1 .. world-1 of a cell, started from rank 0."""

    def __init__(self, world: int, args: tuple, device):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.device = device
        self.port = free_port()
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=worker, args=(
            r, world, self.port, self.queue, device.type) + args)
            for r in range(1, world)]
        for p in self.procs:
            p.start()
        init(0, world, self.port, device)

    def order(self, op: int, seed: int = 0, count: int = 0):
        order(op, seed, count, self.device)

    def finish(self) -> list:
        """Stop the ranks and wait for them; their reports, in rank
        order. Every rank leaves the group before any is joined: a rank
        that leaves waits for the others."""
        import torch.distributed as dist
        self.order(STOP)
        reports = [self.queue.get(timeout=600) for _ in self.procs]
        dist.destroy_process_group()
        for p in self.procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join()
        return sorted(reports, key=lambda r: r["rank"])


def worker(rank: int, world: int, port: int, queue, device_type: str,
           root, cfg: dict, traffic: dict, seed: int, warm: dict) -> None:
    from . import profile, run, system
    from .reference import scene as ref_scene
    run.ROOT = root
    ref_scene.ROOT = root / "portbench"
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device(device_type))
    init(rank, world, port, device)
    on_card = device.type == "cuda"
    study = system.build(cfg, traffic, device)
    study.run(system.call_seed(seed, 3 * 10 ** 6), **warm)
    read = system.counters if on_card else (lambda: {})
    rounds, busy = [], None
    while True:
        op, seed, count = order(0, device=device)
        if op == STOP:
            break
        if op == CALL:
            c0 = read()
            study.run(seed)
            if on_card:
                torch.cuda.synchronize(device)
            c1 = read()
            rounds.append(sum(c1[k] - c0[k] for k in c1))
        elif op == PROFILE and on_card:
            busy = profile.profile_calls(study, [
                system.call_seed(seed, 10 ** 6 + k) for k in range(count)],
                read).busy_s
    queue.put({"rank": rank, "rounds": rounds, "busy_s": busy,
               "peak": torch.cuda.max_memory_allocated(device)
               if on_card else None})
    import torch.distributed as dist
    dist.destroy_process_group()
