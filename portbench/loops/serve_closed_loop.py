"""Offline batched serving, a closed loop: one client keeps ``in_flight``
requests of ``batch`` images in flight and submits the next request the
moment one completes.  A request is a batch of new images, drawn on the
device from the seed on a stream of its own (``Run.side_stream``) ahead
of the engine, and is complete when its logits are in host memory.

Traffic file keys:
    kind        "serve_closed_loop"
    batch       images a request
    in_flight   requests in flight
    dtype       the engine's serving dtype ("bfloat16")
    engine      keyword arguments of the engine's entry (its route)
    check_images  images of the window's answers compared with the
                  reference after the window (whole requests drawn from
                  the seed, kept as they complete)

End to end:
    img_per_s   images whose logits reached the host, over the window
                (first submission to the last completion)
    p95_ms      95th percentile of every request's latency, from the
                moment it was due (its slot freed) to its logits on the
                host
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench.core import checks
from portbench.reference import init

E2E = ("img_per_s", "p95_ms")
WARM_S = 1.0


def run(run) -> dict:
    cfg, tr, dev = run.cfg, run.traffic, run.device
    batch, depth = tr["batch"], tr["in_flight"]
    dtype = getattr(torch, tr["dtype"])
    px = cfg["image_size"]
    cuda = dev.type == "cuda"
    spans, win = run.spans, run.window
    sd = run.weights()
    run.stamp("weights")
    fwd = run.system.serving(cfg, tr, sd, dev, run.seed)
    run.stamp("program")

    def draw(i: int, salt: int = 1) -> torch.Tensor:
        gen = init.seeded(run.seed, salt, i, device=dev)
        return init.images(gen, batch, px, dev).to(dtype)

    def submit(i: int, buf: torch.Tensor, salt: int = 1):
        with spans("draw"):
            x = run.on_side_stream(lambda: draw(i, salt))
        with spans("forward"):
            logits = fwd(x)
        with spans("copy out"):
            buf.copy_(logits, non_blocking=cuda)
            done = torch.cuda.Event() if cuda else None
            if cuda:
                done.record()
        return done

    def wait(done) -> None:
        with spans("wait"):
            if done is not None:
                done.synchronize()

    # warm-up: the window's loop, every shape it uses, on other images,
    # for WARM_S at the least (the card's clocks settle under load)
    with torch.inference_mode():
        classes = fwd(draw(0, salt=2)).shape[1]
    bufs = [torch.empty((batch, classes), pin_memory=cuda)
            for _ in range(depth)]
    warming, start, i = collections.deque(), time.perf_counter(), 0
    while i <= depth or time.perf_counter() - start < WARM_S:
        if len(warming) == depth:
            wait(warming.popleft())
        warming.append(submit(i, bufs[i % depth], salt=2))
        i += 1
    while warming:
        wait(warming.popleft())
    if cuda:
        torch.cuda.synchronize()
    # the requests compared after the window, drawn from the seed among
    # the first half of those the warm-up's pace would complete (kept as
    # they complete; the others are only copied to the host)
    n_check = max(1, tr["check_images"] // batch)
    reach = max(n_check, int(0.5 * i / (time.perf_counter() - start)
                             * run.seconds))
    rng = np.random.default_rng([run.seed, 5])
    sample = set(rng.choice(reach, n_check, replace=False).tolist())

    latencies, answers = [], {}
    pending = collections.deque()
    free = collections.deque(range(depth))
    win.begin()
    due = collections.deque([win.t0] * depth)
    i = 0
    while True:
        if free and time.perf_counter() - win.t0 < run.seconds:
            slot = free.popleft()
            pending.append((slot, due.popleft(), submit(i, bufs[slot])))
            i += 1
            continue
        if not pending:
            break
        slot, was_due, done = pending.popleft()
        wait(done)
        now = time.perf_counter()
        if len(latencies) in sample:
            answers[len(latencies)] = bufs[slot].clone()
        latencies.append(now - was_due)
        free.append(slot)
        due.append(now)
    if cuda:
        torch.cuda.synchronize()
    win.end()
    win.units, win.images = i, i * batch
    run.read_memory_peak()
    del fwd, bufs
    run.free_program()

    got, ref = [], []
    for j in sorted(answers):
        got.append(answers[j].float())
        ref.append(run.system.reference.forward(sd, cfg, draw(j)).to("cpu"))
    values = checks.logit_checks(torch.cat(got), torch.cat(ref))
    tenth = max(1, len(latencies) // 10)
    run.note({"latency_ms": {
        "p50_first_tenth": float(np.median(latencies[:tenth])) * 1e3,
        "p50_rest": float(np.median(latencies[tenth:] or latencies)) * 1e3,
        "p99": float(np.percentile(latencies, 99)) * 1e3,
        "max": max(latencies) * 1e3}})
    return {"e2e": {"img_per_s": i * batch / win.seconds,
                    "p95_ms": float(np.percentile(latencies, 95)) * 1e3},
            "values": values, "attempted": i,
            "failed": i - len(latencies)}
