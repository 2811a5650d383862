"""Input pipeline (counterpart of thermal3d/data/pipeline.py): the
decode / dispatch / consume overlap shared by `InferenceEngine.infer_paths`
and `pseudo_gt.generate_pseudo_gt`, the staging of their inputs and the
event-ordered fetch of their results through pinned host memory, and the
training loop's prefetching `BatchLoader`.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# buffer sets of PinnedStage/PinnedFetch, used in turn: pipelined_batches has
# one batch in flight while it starts the next
N_SETS = 2


def split_index(n: int, val_fraction: float = 0.2, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Random 0.8/0.2 split (train_thermal_dustr.py:78-81 random_split)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(n * (1.0 - val_fraction))
    return perm[:n_train], perm[n_train:]


def pipelined_batches(chunks: Sequence, decode, dispatch, consume,
                      prefetch: int = 2) -> None:
    """One background thread decodes chunks i+1..i+prefetch while the device
    computes chunk i, and chunk i is consumed only after chunk i+1 has been
    dispatched, so decode, compute and fetch overlap while results stay in
    order.

    decode(chunk)     runs on the background thread; its result goes to
                      dispatch on the calling thread.
    dispatch(decoded) launches the device work and returns a token, or None
                      to skip the chunk (every frame failed to decode).
    consume(token)    waits for a dispatched token and writes it out.

    consume(i) runs after dispatch(i+1) has queued its launches: a consume
    that waits on the whole stream (a plain .cpu()) would wait for chunk
    i+1's compute too. PinnedFetch orders it by an event instead.
    """
    inflight = None
    with cf.ThreadPoolExecutor(1) as pool:
        pending: collections.deque = collections.deque(
            pool.submit(decode, c) for c in chunks[: prefetch + 1])
        next_i = len(pending)
        for _ in range(len(chunks)):
            decoded = pending.popleft().result()
            if next_i < len(chunks):
                pending.append(pool.submit(decode, chunks[next_i]))
                next_i += 1
            token = dispatch(decoded)
            if token is None:
                continue
            if inflight is not None:  # consume i-1 after dispatching i
                consume(inflight)
            inflight = token
        if inflight is not None:
            consume(inflight)


class PinnedStage:
    """numpy batches → device tensors without waiting on earlier work.

    A copy from pageable host memory blocks the host until the stream has
    run everything queued before it, so the next batch's launches would wait
    for this batch's compute. put(arrays) copies each array into a pinned
    buffer (the N_SETS sets used in turn, each reused only after its last
    copy ended) and queues a non-blocking copy to the device on the current
    stream. On the CPU the arrays are wrapped as they are.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._sets = [dict() for _ in range(N_SETS)]
        self._events = [None] * N_SETS
        self._next = 0

    def put(self, arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in arrays.items()}
        i = self._next
        self._next = (i + 1) % len(self._sets)
        if self._events[i] is not None:
            self._events[i].synchronize()
        bufs, out = self._sets[i], {}
        for k, a in arrays.items():
            buf = bufs.get(k)
            if buf is None or tuple(buf.shape) != a.shape or buf.numpy().dtype != a.dtype:
                buf = bufs[k] = torch.from_numpy(np.empty_like(a)).pin_memory()
            np.copyto(buf.numpy(), a)
            out[k] = buf.to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record(torch.cuda.current_stream(self.device))
        return out


class PinnedFetch:
    """Device results → numpy without waiting on later work.

    start(tensors) queues non-blocking copies of `tensors` into pinned host
    buffers on a copy stream that first waits for the work queued so far on
    the current stream (the batch that produced them), and records an event
    after the copies; finish(token, rows) waits on that event only, then
    copies the first `rows` rows out. A later batch's launches, queued
    between the two, neither delay these copies nor are waited for.

    The N_SETS buffer sets are used in turn; a set whose token has not been
    finished is never written again (RuntimeError). On the CPU the results
    are complete when start() is called and are copied at finish.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._sets = [dict() for _ in range(N_SETS)]
        self._busy = [False] * N_SETS
        self._next = 0
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def start(self, tensors: Mapping[str, torch.Tensor]):
        if self._stream is None:
            return None, dict(tensors), None
        i = self._next
        if self._busy[i]:
            raise RuntimeError("PinnedFetch: buffer set still holds an unfinished fetch")
        self._next = (i + 1) % len(self._sets)
        bufs, host = self._sets[i], {}
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            for k, t in tensors.items():
                buf = bufs.get(k)
                if (buf is None or buf.dtype != t.dtype or buf.shape[1:] != t.shape[1:]
                        or buf.shape[0] < t.shape[0]):
                    buf = bufs[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host[k] = buf[:t.shape[0]]
                host[k].copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._busy[i] = True
        # the device tensors stay referenced by the token until the copies end
        return i, host, (event, dict(tensors))

    def finish(self, token, rows: Optional[int] = None,
               into: Optional[Mapping[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
        """Wait for the token's copies and return their first `rows` rows as
        numpy arrays: new ones, or `into`'s, which receive the copy."""
        i, host, pending = token
        if pending is not None:
            pending[0].synchronize()
        out = {}
        for k, v in host.items():
            src = v[:rows].numpy()
            if into is None:
                out[k] = np.array(src)
            else:
                np.copyto(into[k], src)
                out[k] = into[k]
        if i is not None:
            self._busy[i] = False
        return out

    @staticmethod
    def empty_like(token, rows: int) -> Dict[str, np.ndarray]:
        """Uninitialised numpy arrays of `rows` rows, shaped and typed as the
        token's results, for finish(..., into=)."""
        return {k: np.empty((rows, *v.shape[1:]), v.numpy().dtype) for k, v in token[1].items()}


class BatchLoader:
    """Iterable over stacked numpy batches, loaded ahead on a thread pool.

    Epoch e visits `indices` in the order default_rng(seed + e).permutation
    (shuffle) or as given; batches of batch_size, the final partial one
    dropped with drop_last. A dataset with `get_batch(idxs)` loads a batch in
    one call (one decode of all its frames); otherwise samples come from
    __getitem__ on the pool. Samples that fail to load (None) are dropped,
    and with drop_last a batch left short is skipped. Single process only:
    the multi-process slicing of the JAX loader (process_count > 1) waits
    for ROADMAP Queue 1 item 11 (multi-GPU).
    """

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 batch_size: int = 4, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = True,
                 process_id: int = 0, process_count: int = 1):
        if process_count != 1 or process_id != 0:
            raise NotImplementedError("BatchLoader over several processes is not ported "
                                      "(ROADMAP Queue 1 item 11, multi-GPU)")
        self.dataset = dataset
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def local_real_count(self, bi: int) -> int:
        """The number of real samples in batch bi (the last may be short)."""
        return int(np.clip(len(self.indices) - bi * self.batch_size, 0, self.batch_size))

    def _epoch_order(self) -> np.ndarray:
        if not self.shuffle:
            return self.indices
        return np.random.default_rng(self.seed + self._epoch).permutation(self.indices)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        self._epoch += 1
        bs = self.batch_size
        n_batches = len(self)
        get_batch = getattr(self.dataset, "get_batch", None)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending: collections.deque = collections.deque()

            def submit(bi):
                idxs = order[bi * bs:(bi + 1) * bs]
                if get_batch is not None:
                    pending.append(pool.submit(get_batch, idxs))
                else:
                    pending.append(pool.map(self.dataset.__getitem__, idxs))

            for bi in range(min(self.prefetch + 1, n_batches)):
                submit(bi)
            next_submit = min(self.prefetch + 1, n_batches)
            for _ in range(n_batches):
                head = pending.popleft()
                raw = head.result() if get_batch is not None else head
                samples = [s for s in raw if s is not None]
                if next_submit < n_batches:
                    submit(next_submit)
                    next_submit += 1
                if not samples or (self.drop_last and len(samples) < bs):
                    continue
                yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
