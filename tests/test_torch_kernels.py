"""Port parity of the packed-bag kernel module (K1 ``packed_qr_bag``, K3
``packed_bag``; K2 ``packed_tt_bag`` is in ``test_torch_tt.py``) and of
``EmbeddingEngine.serve_gather`` on every kind.

On the CPU the port's wrappers take their plain versions, held against
``repro``'s Pallas kernels in interpret mode at fp32 rtol = atol = 1e-5 (the
plain version sums in another order).  The CUDA kernels are held against the
plain versions on the card in ``test_torch_gpu.py``."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import engine as j_engine  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.kernels import packed_gather as j_pg  # noqa: E402
from repro.launch import serve_rec as j_serve  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.kernels import packed_gather as t_pg  # noqa: E402
from torch_bag_inputs import CASES, bag_inputs, dense_args, qr_args  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_packed_qr_bag_matches_repro(case):
    a = bag_inputs(case)
    t_pg.reset_launches()
    got = t_pg.packed_qr_bag(*qr_args(a, torch.from_numpy))
    expect = j_pg.packed_qr_bag(*qr_args(a, jnp.asarray), interpret=True)
    assert got.dtype == torch.float32 and got.shape == (12, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    assert t_pg.LAUNCHES["packed_qr_bag"] == 0      # the plain version ran


@pytest.mark.parametrize("case", CASES)
def test_packed_bag_matches_repro(case):
    a = bag_inputs(case, seed=1)
    got = t_pg.packed_bag(*dense_args(a, torch.from_numpy))
    expect = j_pg.packed_bag(*dense_args(a, jnp.asarray), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


@pytest.mark.parametrize("arch", ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"])
def test_serve_gather_matches_repro(arch):
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    traces = [j_syn.zipf_trace(jc.vocab_per_table, 5_000, seed=7 + t)
              for t in range(jc.num_tables)]
    j_eng = j_engine.compile(j_engine.plan(
        j_engine.EngineSpec.from_dlrm(jc, serving=True), num_shards=4, trace=traces))
    t_eng = t_engine.compile(t_engine.plan(
        t_engine.EngineSpec.from_dlrm(tc, serving=True), traces, num_shards=4))
    params, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(3), jc)
    tables_np = jax.tree.map(np.asarray, params["tables"])
    j_packed = j_eng.pack(params["tables"])
    t_packed = t_eng.pack(convert.params_from_numpy(
        {"bottom": [], "top": [], "tables": tables_np}, "cpu")["tables"])
    for k in j_packed:
        np.testing.assert_array_equal(t_packed[k].numpy(), np.asarray(j_packed[k]))

    scheds = j_eng.fresh_schedulers()
    idx = np.array(j_syn.dlrm_batch(jc, 6, seed=1, step=0)["idx"])
    emb = j_eng.bags[0].emb
    slot = []
    for t in range(jc.num_tables):
        rows = j_serve.big_rows(idx[:, t], emb)
        # stage only part of the batch so hits and misses both occur
        scheds[t].prefetch(rows[:3])
        slot.append(scheds[t].slots_for(rows))
    slot = np.stack(slot, axis=1).astype(np.int32)
    assert (slot >= 0).any() and (slot < 0).any()
    cache_rows = j_eng.packed_cache_rows(scheds)
    expect = j_eng.serve_gather(j_packed, jnp.asarray(idx), jnp.asarray(slot),
                                jnp.asarray(cache_rows))
    got = t_eng.serve_gather(t_packed, torch.from_numpy(idx), torch.from_numpy(slot),
                             torch.from_numpy(cache_rows))
    assert got.shape == (6, jc.num_tables, jc.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_cpu_wrappers_reject_mixed_devices():
    a = bag_inputs("mixed")
    args = dense_args(a, torch.from_numpy)
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        t_pg.packed_bag(*args)
