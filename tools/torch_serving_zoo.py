"""The seeded workload zoo and the closed-loop replay for the port's SLO
autopilot (the twin of ``benchmarks/serving_bench.py``'s
``--scenario autopilot``, ``:1653-1972``, without jax).

Composable arrival generators, each a production traffic shape:
prefix-heavy interactive chat, long-context RAG, agentic many-short-turn
tool loops, and a diurnal ramp (a peak burst, then an off-peak trickle).
Each emits ``(arrival_s, prompt, max_new, priority, deadline_s,
degrade_to)`` rows and :func:`zoo_tenant_mix` merges them into one
multi-tenant trace. Arrivals are VIRTUAL seconds: the replay runs on a
``SteppingClock`` (every clock read advances 2 ms), so a seed gives
the same schedule, goodput and actuation log on every machine and for
every model: no request has an eos, so no token value steers the
schedule.

:func:`run_autopilot` replays one trace through four static knob
configurations and through ``ServingEngine(..., autopilot=Autopilot())``
and asserts what the JAX bench asserts: the closed loop's goodput beats
every static pass, its high-priority misses do not exceed the best static
pass's, it actuates, every pass feeds the decode step one input layout
(where the JAX bench counts compiled programs), and requests that finish
un-degraded in the closed pass and the reference static pass emit the
same tokens. Under ``stream_rule="chunks"`` (int8 KV, where a prompt
chunked differently starts from its own scale history) only rows with
the same chunk boundaries in both passes must be identical; the others
are returned with their first differing position for the caller to judge.

Run on the CPU with a tiny model:

    python3 tools/torch_serving_zoo.py
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


#: the replay's engine: 4 slots on a clock that ticks 2 ms per read
N_SLOTS = 4
TICK_S = 0.002
#: the trace seed of the closed-loop claim
SEED = 43


# -- the workload zoo ---------------------------------------------------------

def zoo_chat(cfg, rng, t0=0.0, n=8, gap_s=0.15, prefix_len=8,
             turn_len=4, gen=(4, 6), deadline_s=0.6, priority=10):
    """Prefix-heavy interactive chat: one shared system prefix, short turns
    and answers, TIGHT deadlines, high priority."""
    prefix = rng.randint(1, cfg["vocab"] + 1, size=(prefix_len,)).tolist()
    return [(t0 + i * gap_s,
             prefix + rng.randint(1, cfg["vocab"] + 1,
                                  size=(turn_len,)).tolist(),
             int(rng.randint(gen[0], gen[1] + 1)), priority, deadline_s,
             None)
            for i in range(n)]


def zoo_rag(cfg, rng, t0=0.05, n=6, gap_s=0.08, ctx_len=24, gen=24,
            deadline_s=3.0):
    """Long-context RAG: fat prompts, long answers, generous deadlines,
    batch priority: the slot hogs a deadline-aware preemptor trades
    latency from."""
    return [(t0 + i * gap_s,
             rng.randint(1, cfg["vocab"] + 1, size=(ctx_len,)).tolist(),
             gen, 0, deadline_s, None)
            for i in range(n)]


def zoo_agentic(cfg, rng, t0=0.3, loops=5, turns=2, loop_gap_s=0.16,
                turn_gap_s=0.02, turn_len=3, gen=3, deadline_s=0.35):
    """Agentic tool loops: many very short turns, the RAG rows' priority
    class but knife-edge deadlines (class preemption does nothing for
    them)."""
    out = []
    for i in range(loops):
        for j in range(turns):
            out.append((t0 + i * loop_gap_s + j * turn_gap_s,
                        rng.randint(1, cfg["vocab"] + 1,
                                    size=(turn_len,)).tolist(),
                        gen, 0, deadline_s, None))
    return out


def zoo_diurnal(cfg, rng, t0=1.2, peak_n=14, peak_gap_s=0.03,
                off_n=3, off_gap_s=0.3, plen=5, gen=16,
                deadline_s=1.0, degrade_to=4):
    """Diurnal ramp: a peak burst arriving faster than service (each row
    carries a ``Degrade`` budget), then an off-peak trickle that should
    keep its full budget."""
    peak = [(t0 + i * peak_gap_s,
             rng.randint(1, cfg["vocab"] + 1, size=(plen,)).tolist(),
             gen, 0, deadline_s, degrade_to)
            for i in range(peak_n)]
    t1 = t0 + peak_n * peak_gap_s + 0.6
    off = [(t1 + i * off_gap_s,
            rng.randint(1, cfg["vocab"] + 1, size=(plen,)).tolist(),
            gen, 0, deadline_s * 3, degrade_to)
           for i in range(off_n)]
    return peak + off


def zoo_tenant_mix(*segments):
    """Merge generator outputs into one trace, sorted by arrival (ties by
    segment order)."""
    out = []
    for seg in segments:
        out.extend(seg)
    return sorted(out, key=lambda r: r[0])


def make_zoo_trace(cfg, seed: int = SEED):
    """THE seeded zoo trace: chat + RAG + agentic + diurnal on one
    timeline, calibrated to the engine's ~7 clock reads per step so each
    tenant's pathology bites at 4 slots."""
    rng = np.random.RandomState(seed)
    return zoo_tenant_mix(
        zoo_chat(cfg, rng, n=6, gap_s=0.35, deadline_s=0.45),
        zoo_rag(cfg, rng, n=8, gap_s=0.05, ctx_len=24, gen=48,
                deadline_s=4.0),
        zoo_agentic(cfg, rng, t0=0.3, loops=6, loop_gap_s=0.2,
                    deadline_s=0.16),
        zoo_diurnal(cfg, rng, t0=2.3, peak_n=20, peak_gap_s=0.025,
                    gen=16, deadline_s=0.55, degrade_to=4),
    )


def default_autopilot():
    """The closed loop's setpoints (as the JAX bench's): the margin
    absorbs the share of a virtual step the dispatch-median service
    estimate cannot see."""
    from bigdl_tpu_torch.serving import Autopilot, AutopilotConfig

    return Autopilot(AutopilotConfig(
        queue_high=3.0, queue_low=1.0, sustain=2, cooldown=4,
        chunk_min=8, chunk_max=64, gap_target_s=0.05,
        preempt_margin_s=0.12))


#: the static sweep: chunk budget {8, 64} x degrade off, and 32/8 with it
STATIC_SWEEP = {
    "chunk8": dict(chunk_budget=8),
    "chunk64": dict(chunk_budget=64),
    "chunk32_degrade": dict(chunk_budget=32, degrade_at=4),
    "chunk8_degrade": dict(chunk_budget=8, degrade_at=4),
}
REFERENCE_STATIC = "chunk32_degrade"


# -- one replay ----------------------------------------------------------------

@dataclass
class ZooRun:
    """One replay: each trace row's output ids and chosen log-probs, the
    rows that finished clean (normal finish, budget intact), each row's
    chunk boundaries ``((start, n), ...)`` per admission, and the run's
    figures."""

    outs: Dict[int, np.ndarray]
    logprobs: Dict[int, np.ndarray]
    clean: set
    chunks: Dict[int, tuple]
    stats: dict = field(default_factory=dict)


def decode_layout(args) -> tuple:
    """The decode step's input layout: shapes and dtypes of the tokens,
    the active mask, the knob tensors and the carry leaves."""
    tensors = [args[1], args[2]] + list(args[4].values()) \
        + list(args[3].values())
    return tuple((tuple(t.shape), str(t.dtype)) for t in tensors)


def _missed(req) -> bool:
    if req is None:
        return True
    if req.finish_reason not in (None, "length", "stop"):
        return True                     # shed / deadline / error
    return (req.deadline_time is not None
            and req.finish_time is not None
            and req.finish_time > req.deadline_time)


def run_zoo_engine(lm, trace, autopilot=None, degrade_at=None,
                   chunk_budget=32, compute_dtype=None, kv_dtype=None,
                   device=None, sync=None) -> ZooRun:
    """Replay ``trace`` in VIRTUAL time (the JAX bench's
    ``_run_zoo_engine``) through a chunked priority engine of
    :data:`N_SLOTS` slots: requests are submitted when the engine's
    ``SteppingClock`` reaches their arrival, and an idle engine jumps the
    clock to the next arrival. ``sync`` (e.g. ``torch.cuda.synchronize``)
    closes the wall-time measurement of the run and of each step."""
    from bigdl_tpu_torch.serving import Degrade, ServingEngine, SteppingClock

    clk = SteppingClock(TICK_S)
    eng = ServingEngine(lm, n_slots=N_SLOTS, compute_dtype=compute_dtype,
                        kv_dtype=kv_dtype, policy="priority",
                        admission="chunked", chunk_budget=chunk_budget,
                        clock=clk, degrade_at=degrade_at,
                        autopilot=autopilot, device=device)
    layouts = set()
    step_fn = eng._step_fn

    def recording_step(*args):
        layouts.add(decode_layout(args))
        return step_fn(*args)

    eng._step_fn = recording_step
    chunk_log: Dict[int, list] = {}
    feed = eng.admitter._feed_chunk

    def recording_feed(slot, req, pf, done, n):
        chunk_log.setdefault(req.req_id, []).append((done, n))
        return feed(slot, req, pf, done, n)

    eng.admitter._feed_chunk = recording_feed
    sample_s: List[float] = []
    if autopilot is not None:
        sample = autopilot.sample

        def timed_sample(engine):
            t = time.perf_counter()
            sample(engine)
            sample_s.append(time.perf_counter() - t)

        autopilot.sample = timed_sample
    order = sorted(range(len(trace)), key=lambda i: (trace[i][0], i))
    rids: Dict[int, int] = {}
    step_wall: List[float] = []
    i, steps = 0, 0
    t_run = time.perf_counter()
    while i < len(order) or not eng.idle():
        while i < len(order) and trace[order[i]][0] <= clk.t:
            ti = order[i]
            _, prompt, n_new, pri, dl, dg = trace[ti]
            rids[ti] = eng.submit(
                prompt, max_new_tokens=n_new, priority=pri, deadline_s=dl,
                degrade=None if dg is None else Degrade(max_new_tokens=dg))
            i += 1
        if eng.idle() and i < len(order):
            clk.advance(max(0.0, trace[order[i]][0] - clk.t))
            continue
        n0 = eng.metrics.decode_step_count
        t = time.perf_counter()
        eng.step()
        if eng.metrics.decode_step_count > n0:
            if sync is not None:
                sync()
            step_wall.append(time.perf_counter() - t)
        steps += 1
    if sync is not None:
        sync()
    wall = time.perf_counter() - t_run
    s = eng.metrics.summary()
    hi = {ti for ti, r in enumerate(trace) if r[3] > 0}
    missed = {ti for ti in range(len(trace))
              if _missed(eng.request(rids[ti]))}
    outs, lps, clean, chunks = {}, {}, set(), {}
    for ti in range(len(trace)):
        req = eng.request(rids[ti])
        chunks[ti] = tuple(chunk_log.get(rids[ti], ()))
        if req is None:
            continue
        outs[ti] = np.asarray(req.output, np.int64)
        lps[ti] = np.asarray(req.logprobs, np.float32)
        # CLEAN: a normal finish with the submitted budget intact
        if req.finish_reason in ("length", "stop") and not req.degraded:
            clean.add(ti)
    acts: Dict[str, int] = {}
    if autopilot is not None:
        for _, name, _ in autopilot.bus.log:
            acts[name] = acts.get(name, 0) + 1
    n_tok = int(sum(len(o) for o in outs.values()))
    stats = {
        "virtual_s": round(clk.t, 3),
        "steps": steps,
        "decode_steps": eng.metrics.decode_step_count,
        "goodput": round(s.get("serving/goodput", 0.0), 3),
        "finished_in_slo": s.get("serving/finished_in_slo", 0.0),
        "deadline_missed": s.get("serving/deadline_missed", 0.0),
        "hi_missed": len(missed & hi),
        "lo_missed": len(missed - hi),
        "preempted": s.get("serving/preempted", 0.0),
        "degraded": s.get("serving/degraded", 0.0),
        "degrade_restored": s.get("serving/degrade_restored", 0.0),
        "actuations": (len(autopilot.bus.log) if autopilot is not None
                       else 0),
        "actuations_by_actuator": acts,
        "decode_layouts": len(layouts),
        "wall_s": wall,
        "tokens": n_tok,
        "tok_s": n_tok / wall if wall > 0 else 0.0,
        "step_p50_ms": (float(np.percentile(step_wall, 50)) * 1e3
                        if step_wall else 0.0),
    }
    if sample_s:
        stats["sample_us_p50"] = float(np.percentile(sample_s, 50)) * 1e6
        stats["samples"] = len(sample_s)
    return ZooRun(outs, lps, clean, chunks, stats)


# -- the closed loop against the static sweep ----------------------------------

def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def compare_streams(a: ZooRun, b: ZooRun, stream_rule: str = "exact"):
    """Hold ``a``'s streams to ``b``'s. Rows clean in both must be
    identical (under ``"chunks"``, only those whose chunk boundaries are
    the same in both); any other row's shorter stream must be a prefix of
    the longer. Returns ``(n_identical, partings)`` where ``partings``
    lists ``(row, first differing position, same_chunks)`` of rows that
    were not required to match and do not."""
    if stream_rule not in ("exact", "chunks"):
        raise ValueError(f"unknown stream_rule {stream_rule!r}")
    n_identical, partings = 0, []
    for ti, x in a.outs.items():
        y = b.outs.get(ti)
        if y is None:
            continue
        same = a.chunks.get(ti) == b.chunks.get(ti)
        must = stream_rule == "exact" or same
        n = min(len(x), len(y))
        if ti in a.clean and ti in b.clean:
            if np.array_equal(x, y):
                n_identical += 1
                continue
        elif np.array_equal(x[:n], y[:n]):
            continue
        if must:
            raise AssertionError(
                f"zoo row {ti}: streams differ between the closed loop and "
                f"the reference static pass ({x.tolist()} vs {y.tolist()}); "
                "the loop reorders latency, never tokens")
        i = int(np.argmax(x[:n] != y[:n])) if (x[:n] != y[:n]).any() else n
        partings.append((ti, i, same))
    return n_identical, partings


def run_autopilot(lm, compute_dtype=None, kv_dtype=None, device=None,
                  stream_rule: str = "exact", sync=None, probe=None) -> dict:
    """The closed loop against every static config on one seeded zoo trace
    (module docstring). ``probe(name, run)``, when given, runs each pass
    (``run()`` returns its :class:`ZooRun`) and returns what ``run()``
    returned, so a caller can count what the pass launches. Returns the
    per-pass figures and, for the caller's checks, the runs themselves
    under ``"runs"``."""
    vocab = lm[0].n_index
    trace = make_zoo_trace({"vocab": vocab}, SEED)
    kw = dict(compute_dtype=compute_dtype, kv_dtype=kv_dtype, device=device,
              sync=sync)
    passes = [(name, dict(knobs)) for name, knobs in STATIC_SWEEP.items()]
    passes.append(("closed", {}))
    runs = {}
    for name, knobs in passes:
        if name == "closed":
            knobs["autopilot"] = default_autopilot()

        def run(knobs=knobs):
            return run_zoo_engine(lm, trace, **kw, **knobs)

        runs[name] = run() if probe is None else probe(name, run)
    closed = runs["closed"].stats
    statics = {n: r.stats for n, r in runs.items() if n != "closed"}
    for name, st in statics.items():
        _check(closed["goodput"] > st["goodput"],
               f"closed loop goodput {closed['goodput']} did not beat static "
               f"config {name} ({st['goodput']}) on the seeded zoo trace")
    layouts = {st["decode_layouts"] for st in (*statics.values(), closed)}
    _check(layouts == {1}, f"decode input layouts per pass: {layouts}")
    best_hi = min(st["hi_missed"] for st in statics.values())
    _check(closed["hi_missed"] <= best_hi,
           f"closed loop hi-priority misses {closed['hi_missed']} regressed "
           f"against the best static {best_hi}")
    _check(closed["actuations"] > 0, "the closed loop never actuated")
    n_identical, partings = compare_streams(
        runs["closed"], runs[REFERENCE_STATIC], stream_rule)
    _check(n_identical > 0, "no request finished clean in both passes")
    best_static = max(statics, key=lambda k: statics[k]["goodput"])
    return {
        "requests": len(trace),
        "hi_requests": sum(1 for r in trace if r[3] > 0),
        "static": statics, "closed": closed,
        "best_static": best_static,
        "goodput_gain_vs_best": round(
            closed["goodput"] - statics[best_static]["goodput"], 3),
        "identical_rows": n_identical, "partings": partings,
        "trace": trace, "runs": runs,
    }


def main() -> None:
    import json
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bigdl_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(512, hidden_size=128, n_heads=4, n_layers=2,
                       max_len=128, output="logits", device="cpu", seed=17)
    lm.evaluate()
    out = run_autopilot(lm, device="cpu")
    for name, st in (*out["static"].items(), ("closed", out["closed"])):
        print(json.dumps({"pass": name, **st}))
    print(json.dumps({k: out[k] for k in ("best_static",
                                          "goodput_gain_vs_best",
                                          "identical_rows")}))


if __name__ == "__main__":
    main()
