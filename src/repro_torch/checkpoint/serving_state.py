"""Token-level serving state commit/restore (SpotServe, survey §V.A).

A serving instance on preemptible capacity commits per-request progress — the
token ids generated so far and the scheduler metadata — at token granularity.
On preemption, a replacement instance restores the log and *recomputes* KV via
prefill of (prompt + generated-so-far) rather than shipping KV bytes: for the
survey's spot-instance scenario the recompute is one chunked prefill, which is
cheaper than transferring hundreds of MB of KV over the provisioning path.

The log is append-only JSONL so a partially written file is still recoverable
up to the last complete line (crash-consistent). A copy of
``repro.checkpoint.serving_state``: the same file format, so each package
restores the other's log.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


class ServingStateLog:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def commit(self, request_id: str, prompt: List[int], generated: List[int],
               meta: Optional[dict] = None) -> None:
        rec = {"id": request_id, "prompt": prompt, "generated": generated,
               "meta": meta or {}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def restore(self) -> Dict[str, dict]:
        """Latest committed state per request id (later commits win)."""
        out: Dict[str, dict] = {}
        if not os.path.exists(self.path):
            return out
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail write: recover up to last complete line
                out[rec["id"]] = rec
        return out
