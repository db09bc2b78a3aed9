"""Serving metrics: TTFT / TPOT / throughput, Andes QoE, VTC fairness counters."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.request import SeqState


@dataclasses.dataclass
class RequestMetrics:
    request_id: str
    ttft: float
    tpot: float  # mean time per output token after the first
    e2e: float
    num_prompt: int
    num_generated: int
    prefix_hit_tokens: int
    preemptions: int
    qoe: float
    # per-token emission timestamps (engine wall clock) — what the p50/p95/
    # p99 inter-token latency percentiles in benchmarks/common.py
    # (``latency_percentiles``) are computed from; a mean TPOT hides the
    # tail stalls (mirror re-uploads, preemptions) that SLOs care about
    token_times: List[float] = dataclasses.field(default_factory=list)


def latency_percentiles(metrics: List["RequestMetrics"]) -> Dict[str, float]:
    """p50/p95/p99 inter-token latency (seconds) over all finished requests.

    Pools every request's successive token-time deltas — the per-token view
    of TPOT. Empty input (or single-token streams only) yields zeros so
    callers can always log the keys."""
    deltas: List[float] = []
    for m in metrics:
        deltas.extend(b - a for a, b in zip(m.token_times, m.token_times[1:]))
    if not deltas:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    deltas.sort()

    def pick(q: float) -> float:
        # ceil-based nearest-rank: the q-quantile of n samples is the
        # ceil(q*n)-th order statistic. The old int(q*n) index was biased
        # one rank high at small n (p50 of 2 samples returned the max)
        # and only returned a sane p99 via the min() clamp.
        return deltas[max(0, math.ceil(q * len(deltas)) - 1)]

    return {"p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99)}


def qoe_score(token_times: List[float], arrival: float, *, expected_ttft: float,
              expected_tds: float) -> float:
    """Andes-style QoE: fraction of tokens delivered no later than the expected
    token-delivery timeline (TDT). expected_tds = tokens/sec a user consumes."""
    if not token_times:
        return 0.0
    ok = 0
    for i, t in enumerate(token_times):
        expected = arrival + expected_ttft + i / expected_tds
        if t <= expected + 1e-9:
            ok += 1
    return ok / len(token_times)


def finalize_request(seq: SeqState, *, expected_ttft: float = 1.0,
                     expected_tds: float = 10.0) -> RequestMetrics:
    arrival = seq.request.arrival_time
    ttft = (seq.first_token_time - arrival) if seq.first_token_time else 0.0
    n = len(seq.generated)
    if n > 1 and seq.finish_time and seq.first_token_time:
        tpot = (seq.finish_time - seq.first_token_time) / (n - 1)
    else:
        tpot = 0.0
    e2e = (seq.finish_time - arrival) if seq.finish_time else 0.0
    return RequestMetrics(
        request_id=seq.request_id, ttft=ttft, tpot=tpot, e2e=e2e,
        num_prompt=seq.prompt_len, num_generated=n,
        prefix_hit_tokens=seq.prefix_hit_tokens, preemptions=seq.preemptions,
        qoe=qoe_score(seq.token_times, arrival, expected_ttft=expected_ttft,
                      expected_tds=expected_tds),
        token_times=list(seq.token_times))


@dataclasses.dataclass
class SpeculativeStats:
    """Draft–verify acceptance accounting (survey §II.B speculative decoding).

    ``proposed``/``accepted`` count draft tokens through the rejection
    sampler; ``emitted`` counts tokens actually appended by speculative steps
    (accepted prefix + the corrected/bonus token, minus stop-condition
    truncation), so ``emitted / steps`` is the realized tokens-per-step the
    speedup comes from. ``disabled_at_step`` records when the engine's
    auto-disable tripped (windowed acceptance below the configured floor)."""
    steps: int = 0  # speculative batches executed
    proposed: int = 0
    accepted: int = 0
    emitted: int = 0
    disabled_at_step: Optional[int] = None

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.emitted / self.steps if self.steps else 0.0


class VTCCounter:
    """Virtual Token Counter (fairness in serving LLMs, survey §VI.C).

    Tracks weighted service per user; the scheduler prioritizes the least-served
    user. Input and output tokens cost differently (output ~2x input).
    """

    def __init__(self, input_cost: float = 1.0, output_cost: float = 2.0):
        self.input_cost = input_cost
        self.output_cost = output_cost
        self.counters: Dict[str, float] = {}

    def charge(self, user: str, *, input_tokens: int = 0, output_tokens: int = 0):
        self.counters[user] = self.counters.get(user, 0.0) + \
            self.input_cost * input_tokens + self.output_cost * output_tokens

    def service(self, user: str) -> float:
        return self.counters.get(user, 0.0)

    def fairness_gap(self) -> float:
        if not self.counters:
            return 0.0
        vals = list(self.counters.values())
        return max(vals) - min(vals)
