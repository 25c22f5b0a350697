"""Host-sharded data pipeline with background prefetch (a copy of
``repro/data/pipeline.py``).

Each host process pulls only its shard (shard = process_index), prefetches
`prefetch` batches on a worker thread, and tags every batch with its step
so checkpoint/restart resumes the stream exactly.  Straggler mitigation
hooks in here: a shard that misses the step deadline can be skipped and
its batch re-balanced (runtime/straggler.py drives the policy)."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

from repro_torch.data.synthetic import make_batch


@dataclass
class PipelineConfig:
    seed: int = 0
    prefetch: int = 2
    shard: int = 0
    n_shards: int = 1


class DataPipeline:
    def __init__(self, cfg, shape, pcfg: PipelineConfig):
        self.cfg, self.shape, self.pcfg = cfg, shape, pcfg
        self._q: queue.Queue = queue.Queue(maxsize=max(pcfg.prefetch, 1))
        self._step = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self, from_step: int = 0) -> "DataPipeline":
        self._step = from_step
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, self.shape, seed=self.pcfg.seed,
                               step=step, shard=self.pcfg.shard,
                               n_shards=self.pcfg.n_shards)
            batch["_step"] = step
            try:
                self._q.put(batch, timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self, timeout: float = 30.0) -> dict:
        return self._q.get(timeout=timeout)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # drain
        while not self._q.empty():
            self._q.get_nowait()
