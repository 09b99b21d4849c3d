"""Request / sequence bookkeeping for the serving engine."""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional

import numpy as np

_ids = itertools.count()


class Phase(str, enum.Enum):
    WAITING = "waiting"          # queued, not yet admitted
    RESTORING = "restoring"      # HCache restoration phase (paper §5)
    PREFILL = "prefill"          # chunked prompt prefill
    DECODE = "decode"            # in the continuous decode batch
    PAUSED = "paused"            # evicted mid-stream; requeued, state in
    DONE = "done"                # the store, resumes via RESTORING


@dataclasses.dataclass
class Request:
    session_id: str
    prompt: np.ndarray                       # (n,) int32 new prompt tokens
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    priority: int = 0                        # PriorityAdmission: higher wins
    # enc-dec (whisper) sessions: (S_enc, d_model) encoder frame
    # embeddings. Required on a session's FIRST residency (the encoder
    # runs once and the result persists as the 'enc' blob); later rounds
    # and resumes restore the cross context from the store instead.
    frames: Optional[np.ndarray] = None
    # arrival stamps. The engine fills both at submit() UNLESS the caller
    # pre-stamped them — the front door (frontend/pump.py) stamps
    # arrival_time at ingress so TTFT includes its queueing, and the SLO
    # harness keys per-request accounting off arrival_step ordering.
    arrival_time: float = 0.0                # perf_counter at arrival
    arrival_step: int = -1                   # engine step_count at arrival
    request_id: int = dataclasses.field(default_factory=lambda: next(_ids))


@dataclasses.dataclass
class SequenceState:
    request: Request
    phase: Phase = Phase.WAITING
    slot: int = -1                           # decode-batch slot
    history_len: int = 0                     # restored tokens
    prefill_done: int = 0                    # pending-prompt tokens processed
    generated: List[int] = dataclasses.field(default_factory=list)
    # mid-stream eviction (Phase.PAUSED) bookkeeping. ``generated`` spans
    # pauses (the full answer so far); the counters record how much of it
    # has been folded back into history / the pending prompt.
    pending_prompt: Optional[np.ndarray] = None  # overrides request.prompt
    pending_from_gen: bool = False           # pending tokens came from
    #                                          ``generated`` (resume feed)
    gen_absorbed: int = 0                    # generated tokens counted in
    #                                          history_len/pending_prompt
    tok_saved: int = 0                       # generated tokens persisted
    #                                          to the store's token blob
    admit_step: int = -1                     # engine step of last admission
    enqueue_step: int = 0                    # engine step of last (re)queue
    #                                          (admission aging baseline)
    pauses: int = 0                          # times evicted mid-stream
    # slot-bound CacheView handle (serving/kv_cache.py); set while the
    # sequence holds a batch slot, None when queued/paused/done
    view: Optional[object] = None
    # incremental restoration (core/restoration.py); set while RESTORING
    executor: Optional[object] = None
    restored: bool = False                   # completed a restoration
    # metrics
    ttft_wall: Optional[float] = None
    restore_sim: float = 0.0                 # simulated restoration seconds
    restore_wall: float = 0.0
    first_token_step: Optional[int] = None

    @property
    def effective_prompt(self) -> np.ndarray:
        """Tokens to prefill this residency: the original prompt, or the
        resume feed (last sampled token) after a mid-stream eviction."""
        return (self.pending_prompt if self.pending_prompt is not None
                else self.request.prompt)

    @property
    def total_len(self) -> int:
        """True token length of the session's stream (history + prompt +
        generated), counting each generated token once even after pauses
        folded a prefix of ``generated`` into ``history_len``."""
        return (self.history_len + self.prefill_done + len(self.generated)
                - self.gen_absorbed)

    def finished(self) -> bool:
        r = self.request
        if len(self.generated) >= r.max_new_tokens:
            return True
        return bool(self.generated and r.eos_token is not None
                    and self.generated[-1] == r.eos_token)
