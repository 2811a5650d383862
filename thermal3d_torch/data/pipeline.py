"""Input pipeline (counterpart of thermal3d/data/pipeline.py): the
decode / dispatch / consume overlap shared by `InferenceEngine.infer_paths`
and `pseudo_gt.generate_pseudo_gt`, the staging of their inputs and the
event-ordered fetch of their results through pinned host memory, and the
training loop's prefetching `BatchLoader`.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple

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
    and with drop_last a batch left short is skipped.

    batch_size is the GLOBAL batch size. With process_count > 1 (one
    process a 'data' position, core/distributed.py) every process computes
    the same global order and process p loads only rows [p·B/P, (p+1)·B/P)
    of each global batch, so the union over the processes is the
    single-process stream. With drop_last=False the final global batch may
    be partial: every process's slice is then padded to B/P rows with a
    valid index, so all processes yield the same number of batches (their
    collective steps stay in lockstep); local_real_count(bi) counts the
    real rows. A sample that fails to load lies in one process's slice
    only, so whether a global batch is skipped is put to every process:
    `agree(keep)` takes this process's verdict and returns True only when
    every process keeps the batch (core/mesh.py::Mesh.all_agree over
    'data'); every process then skips the batch that one process alone
    would have, as a single process skips it. Without `agree` (the JAX
    loader's behaviour) that process alone skips it, and its collectives
    pair with the other processes' steps of the next batch.
    """

    def __init__(self, dataset, indices: Optional[Sequence[int]] = None,
                 batch_size: int = 4, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = True,
                 process_id: int = 0, process_count: int = 1,
                 agree: Optional[Callable[[bool], bool]] = None):
        self.dataset = dataset
        self.agree = agree
        self.indices = np.asarray(indices if indices is not None else np.arange(len(dataset)))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._epoch = 0
        if batch_size % process_count:
            raise ValueError(f"global batch size {batch_size} not divisible by "
                             f"process_count {process_count}")
        if not 0 <= process_id < process_count:
            raise ValueError(f"process_id {process_id} out of range [0, {process_count})")
        self.process_id = process_id
        self.process_count = process_count

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def local_real_count(self, bi: int) -> int:
        """The real (not padded) rows of this process's slice of batch bi."""
        bs_local = self.batch_size // self.process_count
        start = bi * self.batch_size + self.process_id * bs_local
        return int(np.clip(len(self.indices) - start, 0, bs_local))

    def _epoch_order(self) -> np.ndarray:
        if not self.shuffle:
            return self.indices
        return np.random.default_rng(self.seed + self._epoch).permutation(self.indices)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        self._epoch += 1
        bs = self.batch_size
        bs_local = bs // self.process_count
        lo = self.process_id * bs_local
        n_batches = len(self)
        get_batch = getattr(self.dataset, "get_batch", None)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            pending: collections.deque = collections.deque()

            def submit(bi):
                idxs = order[bi * bs + lo:bi * bs + lo + bs_local]
                if not self.drop_last and self.process_count > 1 and len(idxs) < bs_local:
                    # a short final global batch: pad this slice (it may
                    # hold none of the real rows) so every process yields
                    # a full-shape batch for every global batch
                    idxs = np.concatenate([idxs, np.broadcast_to(order[0],
                                                                 (bs_local - len(idxs),))])
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
                keep = bool(samples) and not (self.drop_last and len(samples) < bs_local)
                if self.agree is not None:
                    keep = self.agree(keep)
                if not keep:
                    continue
                yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}
