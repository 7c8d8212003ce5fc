"""The port's block allocator, look-ahead scheduler and paged cache
writes: the reference's scheduling decisions on the same operation
traces, and the drop-block write semantics."""
import numpy as np
import pytest
import torch

from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.serving.request import Request
from repro.serving.scheduler import BlockAllocator, LookaheadScheduler
from repro_torch.configs import get_config
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.models import cache as t_cache
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.request import RequestState
from repro_torch.serving.scheduler import BlockAllocator as TAllocator
from repro_torch.serving.scheduler import LookaheadScheduler as TScheduler


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_trace_matches_reference(seed):
    """Random alloc/free traces hand out the same block ids in the same
    order as the reference allocator, and refuse the same asks."""
    rng = np.random.RandomState(seed)
    ref, port = BlockAllocator(24, 16), TAllocator(24, 16)
    held_r, held_p = [], []
    for _ in range(200):
        if held_r and rng.rand() < 0.45:
            i = rng.randint(len(held_r))
            ref.free(held_r.pop(i))
            port.free(held_p.pop(i))
        else:
            n = int(rng.randint(0, 7))
            got_r, got_p = ref.alloc(n), port.alloc(n)
            assert got_r == got_p
            if got_r:
                held_r.append(got_r)
                held_p.append(got_p)
        assert (ref.n_free, ref.n_used) == (port.n_free, port.n_used)


def test_allocator_refuses_double_free():
    a = TAllocator(4, 16)
    a.free(a.alloc(4))
    with pytest.raises(AssertionError):
        a.free([0])


def _schedulers(policy, slots=2, max_seq=64, bs=8, nblocks=8):
    kw = dict(max_batch_size=slots, max_seq_len=max_seq, paged_kv=True,
              kv_block_size=bs, num_kv_blocks=nblocks)
    return (LookaheadScheduler(ServingConfig(**kw),
                               SpecDecodeConfig(policy=policy)),
            TScheduler(TServing(**kw), TSpec(policy=policy)))


@pytest.mark.parametrize("policy", ["dsde", "static", "autoregressive"])
def test_admission_grow_preempt_match_reference(policy):
    """Admission (charge, queue when dry, reject oversize), growth with
    LIFO preemption, requeue at the front, shrink and readmit: the same
    decisions as the reference, step by step."""
    ref, port = _schedulers(policy)
    lens = [(24, 20), (24, 20), (40, 8), (30, 60)]     # the last is oversize
    reqs_r = [Request(i, prompt=[1] * p, max_new_tokens=n)
              for i, (p, n) in enumerate(lens)]
    reqs_p = [TRequest(i, prompt=[1] * p, max_new_tokens=n)
              for i, (p, n) in enumerate(lens)]
    for r, t in zip(reqs_r, reqs_p):
        ref.submit(r)
        port.submit(t)

    def same():
        assert ([r.request_id for r in ref.queue]
                == [r.request_id for r in port.queue])
        for r, t in zip(reqs_r, reqs_p):
            assert (r.slot, r.block_ids, r.state.value, r.preemptions) == (
                t.slot, t.block_ids, t.state.value, t.preemptions)
        np.testing.assert_array_equal(ref.lookahead_slots(),
                                      port.lookahead_slots())

    assert ([r.request_id for r in ref.admit()]
            == [r.request_id for r in port.admit()])
    same()
    new_r, pre_r = ref.ensure_capacity(reqs_r[0], 64)
    new_p, pre_p = port.ensure_capacity(reqs_p[0], 64)
    assert new_r == new_p
    assert [r.request_id for r in pre_r] == [r.request_id for r in pre_p]
    same()
    ref.shrink_to(reqs_r[0], 24)
    port.shrink_to(reqs_p[0], 24)
    reqs_r[1].output, reqs_p[1].output = [5, 7], [5, 7]
    assert ([r.request_id for r in ref.admit()]
            == [r.request_id for r in port.admit()])
    same()
    assert ([r.request_id for r in ref.pop_rejected()]
            == [r.request_id for r in port.pop_rejected()])
    assert reqs_p[1].state == RequestState.RUNNING


def test_pool_smaller_than_one_sequence_is_refused():
    with pytest.raises(ValueError, match="max-length"):
        TScheduler(TServing(max_batch_size=2, max_seq_len=256, paged_kv=True,
                            kv_block_size=16, num_kv_blocks=8), TSpec())


def test_dropped_writes_land_in_the_drop_block():
    """Masked positions, positions past the table and unallocated table
    entries never touch an allocated block; they land in block N (the
    reference's out-of-range drop slot)."""
    cfg = get_config("smollm-135m").reduced()
    n, bs = 6, 4
    c = t_cache.paged_cache_struct(cfg, 2, 16, n, bs)
    assert c["k"].shape[1] == n + 1 and c["kv_pos"].shape[0] == n + 1
    table = torch.tensor([[3, 1, -1, -1], [0, -1, -1, -1]], dtype=torch.int32)
    pos = torch.tensor([[3, 4, 5, 8], [0, 1, 4, 20]], dtype=torch.int32)
    keep = torch.tensor([[True, True, False, True], [True, True, True, True]])
    slots = t_cache.write_slots(pos, table, bs, n + 1, keep)
    # kept + allocated: (row 0, pos 3) -> block 3; (0, 4) -> block 1;
    # (1, 0), (1, 1) -> block 0; the rest are dropped to block n
    assert slots.tolist() == [15, 4, n * bs, n * bs, 0, 1, n * bs, n * bs]
    k_new = torch.randn(2, 4, cfg.num_kv_heads, cfg.resolved_head_dim)
    t_cache.write_kv_paged(c["k"][0], c["v"][0], k_new, k_new, slots)
    t_cache.write_pos_paged(c["kv_pos"], pos, slots)
    pool = c["k"][0].reshape(-1, *k_new.shape[2:])
    for flat, (b, t) in ((15, (0, 0)), (4, (0, 1)), (0, (1, 0)), (1, (1, 1))):
        assert torch.equal(pool[flat], k_new[b, t])
    written = {15, 4, 0, 1}
    untouched = [i for i in range(n * bs) if i not in written]
    assert bool((pool[untouched] == 0).all())
    assert c["kv_pos"].view(-1)[[15, 4, 0, 1]].tolist() == [3, 4, 0, 1]
    assert bool((c["kv_pos"][:n].view(-1)[untouched] == -1).all())
    t_cache.reset_blocks(c["kv_pos"], [3, 0])
    assert bool((c["kv_pos"][[3, 0]] == -1).all())
    assert c["kv_pos"][1, 0].item() == 4
