"""IS — Integer bucket Sort (NPB class S shapes; port of ``repro.npb.is_``).

Checkpoint variables (paper Table I): ``int passed_verification``,
``int key_array[65536]``, ``int bucket_ptrs[512]``, ``int iteration``.

All four are integer state: AD is undefined on them and, as the paper notes,
they are control state — loop index, sort keys, bucket offsets, verification
counter — so the ALWAYS_CRITICAL dtype policy marks every element critical
(expected uncritical = 0, matching the paper).  Every output is int32 too,
so ``scrutinize`` runs no sweep at all, as in the reference.

The sort is genuine: per NPB rank(), each iteration plants
``key_array[iter] = iter`` and ``key_array[iter+MAX_ITERATIONS] = MAX_KEY-iter``,
bucket-counts all keys, builds ``bucket_ptrs`` as the bucket-offset prefix
sum, computes key ranks, and partial-verifies five probe keys.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.npb.common import Benchmark, i32, register

N_KEYS = 1 << 16  # 65536
MAX_KEY = 1 << 11  # 2048
N_BUCKETS = 512
SHIFT = 2  # log2(MAX_KEY / N_BUCKETS)
MAX_ITERATIONS = 10
CKPT_ITER = 5
N_PROBES = 5


def _initial_keys() -> np.ndarray:
    rng = np.random.RandomState(314159)
    # NPB uses randlc doubles; uniform ints preserve the sort structure.
    return rng.randint(0, MAX_KEY, size=N_KEYS).astype(np.int32)


_PROBE_IDX = np.array([2112, 16384, 30000, 48000, 60000])


def _histogram(idx: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.zeros(size, int32).at[idx].add(1)``."""
    ones = torch.ones(idx.shape, dtype=torch.int32, device=idx.device)
    return torch.zeros(size, dtype=torch.int32,
                       device=idx.device).index_add(0, idx.long(), ones)


def _exclusive_prefix(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0, dtype=torch.int32) - counts


def _rank(key_array: torch.Tensor, it: int, probe_idx: torch.Tensor):
    """One NPB rank() pass: plant keys, bucket-count, prefix, rank, probe."""
    key_array = key_array.clone()
    key_array[it] = it
    key_array[it + MAX_ITERATIONS] = MAX_KEY - it

    bucket_ptrs = _exclusive_prefix(_histogram(key_array >> SHIFT, N_BUCKETS))
    key_ranks = _exclusive_prefix(_histogram(key_array, MAX_KEY))

    probe_keys = key_array[probe_idx]
    probe_ranks = key_ranks[probe_keys.long()]
    return key_array, bucket_ptrs, probe_ranks


@register("is")
def make_is(device) -> Benchmark:
    keys0 = _initial_keys()
    probe_idx = torch.as_tensor(_PROBE_IDX, device=device)

    def initial():
        return (torch.as_tensor(keys0, device=device), i32(0, device),
                torch.zeros(N_BUCKETS, dtype=torch.int32, device=device))

    # Reference probe ranks per iteration, from a clean run (stands in for
    # NPB's hard-coded test_rank_array).
    ref_probes = []
    ka = initial()[0]
    for i in range(1, MAX_ITERATIONS + 1):
        ka, _, pr = _rank(ka, i, probe_idx)
        ref_probes.append(pr)

    def run(ka, pv, bp, start, stop):
        for i in range(start, stop):
            ka, bp, pr = _rank(ka, i, probe_idx)
            ok = torch.all(pr == ref_probes[i - 1])
            pv = pv + ok.to(torch.int32) * N_PROBES
        return ka, pv, bp

    def full_verify(ka, pv, bp):
        # the ranked sequence must be sorted
        sorted_keys = torch.repeat_interleave(
            torch.arange(MAX_KEY, dtype=torch.int32, device=device),
            _histogram(ka, MAX_KEY), output_size=N_KEYS)
        in_order = torch.sum((sorted_keys[1:] >= sorted_keys[:-1])
                             .to(torch.int32), dtype=torch.int32)
        return {"passed_verification": pv, "in_order": in_order,
                "bucket_ptr_tail": bp[-1]}

    def checkpoint_state():
        ka, pv, bp = run(*initial(), 1, CKPT_ITER + 1)
        return {
            "passed_verification": pv,
            "key_array": ka,
            "bucket_ptrs": bp,
            "iteration": i32(CKPT_ITER, device),
        }

    def resume(state):
        return full_verify(*run(state["key_array"],
                                state["passed_verification"],
                                state["bucket_ptrs"], CKPT_ITER + 1,
                                MAX_ITERATIONS + 1))

    def reference():
        return full_verify(*run(*initial(), 1, MAX_ITERATIONS + 1))

    return Benchmark(
        name="is",
        total_iters=MAX_ITERATIONS,
        ckpt_iter=CKPT_ITER,
        checkpoint_state=checkpoint_state,
        resume=resume,
        reference=reference,
        expected={
            "passed_verification": (0, 1),
            "key_array": (0, N_KEYS),
            "bucket_ptrs": (0, N_BUCKETS),
            "iteration": (0, 1),
        },
        device=device,
    )
