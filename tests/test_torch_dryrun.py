"""The dry run on the meta device (``repro_torch.launch.dryrun``) against
``repro.launch.dryrun``, and its counters on their own.

Against ``repro`` (its params, caches and 6·N·D from ``jax.eval_shape``):
``param_counts`` total and active for the ten archs, dense and QR, exactly;
``model_flops`` of every run cell, exactly; ``batch_specs``' shapes and
dtypes; ``cache_specs``' bytes at ``decode_32k`` and ``long_500k`` (no
layout departure of ``ROADMAP.md`` §3 changes them: the same bytes);
``--list``, ``repro``'s in a child with one host device.

On their own: after a smoke training step the live bytes are the new
params and AdamW state, exactly; a K9 call adds its output's bytes and its
flops; a meta call of every kernel wrapper gives the kernel's output shape
and dtype, counts in ``bounds.META``, not in ``LAUNCHES``, and never runs
the plain version; the meta collectives of qwen2-1.5b's smoke step on
(1, 2) count what a gloo run of that step counts; the flops are
``FlopCounterMode``'s; ``fit``; ``device.resolve``'s ``meta``.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

os.environ.setdefault("REPRO_XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
import jax  # noqa: E402
from repro.configs import registry as j_reg  # noqa: E402
from repro.launch import dryrun as j_dry  # noqa: E402

from repro_torch import device as device_mod  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry as t_reg  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402
from repro_torch.kernels import bounds, ops, ref  # noqa: E402
from repro_torch.kernels import cached_gather as cg  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gnr_bag as gb  # noqa: E402
from repro_torch.kernels import packed_gather as pg  # noqa: E402
from repro_torch.kernels import qr_gather as qg  # noqa: E402
from repro_torch.kernels import tt_gather as tg  # noqa: E402
from repro_torch.launch import dryrun as t_dry  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(t_reg.ARCHS)
DECODE_CELLS = [(b.arch_id, s.name) for b, s, _ in t_reg.cells() if s.kind == "decode"]


@functools.lru_cache(maxsize=None)
def repro_counts(arch: str, kind: str) -> dict:
    b = j_reg.get(arch)
    cfg = b.config.replace(embedding_kind=kind)
    params = jax.eval_shape(lambda k: j_reg.init_fn(b)(k, cfg)[0], jax.random.PRNGKey(0))
    return j_dry.param_counts(params, cfg)


def port_counts(arch: str, kind: str) -> dict:
    b = t_reg.get(arch)
    cfg = b.config.replace(embedding_kind=kind)
    return t_dry.param_counts(t_reg.abstract_params(b, cfg)[0], cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_repros(arch):
    for kind in ("dense", "qr"):
        assert port_counts(arch, kind) == repro_counts(arch, kind), kind


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_are_repros(arch):
    cells = [s for b, s, _ in t_reg.cells() if b.arch_id == arch]
    assert cells
    counts = port_counts(arch, "dense")
    for shape in cells:
        j_shape = next(s for s in j_reg.LM_SHAPES if s.name == shape.name)
        assert t_dry.model_flops(counts, shape) == j_dry.model_flops(
            repro_counts(arch, "dense"), j_shape), shape.name


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_are_repros(arch):
    for batch, seq in ((256, 4096), (3, 17)):
        got = t_reg.batch_specs(t_reg.get(arch), t_reg.get(arch).config, batch, seq)
        want = j_reg.batch_specs(j_reg.get(arch), j_reg.get(arch).config, batch, seq)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), k
            assert str(got[k].dtype).removeprefix("torch.") == str(np.dtype(v.dtype)), k
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_cache_specs_bytes_are_repros(arch, shape):
    s = next(x for x in LM_SHAPES if x.name == shape)
    b = t_reg.get(arch)
    got = sum(t.numel() * t.element_size() for t in tree.leaves(
        t_reg.cache_specs(b, b.config, s.global_batch, s.seq_len)))
    jb = j_reg.get(arch)
    want = sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize for x in jax.tree.leaves(
        j_reg.cache_specs(jb, jb.config, s.global_batch, s.seq_len)))
    assert got == want


def test_list_is_repros(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_XLA_FLAGS="--xla_force_host_platform_device_count=1")
    out = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--list"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = [x for x in out.stdout.splitlines() if x.strip()]
    assert t_dry.main(["--list"]) == 0
    got = [x for x in capsys.readouterr().out.splitlines() if x.strip()]
    assert got == want
    assert len(got) == 40 and sum(x.endswith(" run") for x in got) == 32


# ---------------------------------------------------------------------------
# the counters on their own
# ---------------------------------------------------------------------------

def smoke_step(arch: str = "qwen2-1.5b"):
    b = t_reg.get(arch)
    cfg = b.smoke
    params, _ = t_reg.abstract_params(b, cfg)
    state = opt.init(params)
    batch = t_reg.batch_specs(b, cfg, 4, 16)
    step = make_train_step(t_reg.train_loss_fn(b, cfg), opt.OptConfig(), microbatches=2)
    return step, params, state, batch


def test_live_bytes_after_a_smoke_step_are_the_new_state():
    step, params, state, batch = smoke_step()
    rec = t_dry.measure(lambda: step(params, state, batch)[:2])
    blocks = lambda n: -(-n // 512) * 512                           # noqa: E731
    mu = sum(blocks(4 * p.numel()) for p in tree.leaves(params))     # fp32 moments
    want = t_dry.storage_bytes(params) + 2 * mu + 512               # and the int32 step
    assert t_dry.storage_bytes(state) == 2 * mu + 512
    assert rec["transient_end"] == want
    assert rec["transient_peak"] > want
    assert rec["kernels"]["flash_fwd"]["calls"] == 2 * 2 * t_reg.get("qwen2-1.5b").smoke.num_layers


def test_step_counter_flops_are_flop_counter_modes():
    step, params, state, batch = smoke_step("granite-moe-3b-a800m")
    rec = t_dry.measure(lambda: step(params, state, batch))
    with FlopCounterMode(display=False) as fcm:
        step(params, state, batch)
    assert rec["torch_flops"] == fcm.get_total_flops() > 0
    b = t_reg.get("granite-moe-3b-a800m")
    fam_params, _ = t_reg.abstract_params(b, b.smoke)
    toks = t_reg.batch_specs(b, b.smoke, 2, 32)
    from repro_torch.models import transformer as T

    rec = t_dry.measure(lambda: T.forward_prefill(fam_params, toks["tokens"], b.smoke, 32),
                        inference=True)
    with torch.inference_mode(), FlopCounterMode(display=False) as fcm:
        T.forward_prefill(fam_params, toks["tokens"], b.smoke, 32)
    assert rec["torch_flops"] == fcm.get_total_flops() > 0


@pytest.mark.parametrize("train", [False, True])
def test_the_loops_a_meta_trace_shortens_count_every_iterations_flops(train):
    """xlstm's sLSTM scan runs one step on meta and its mLSTM one chunk
    (without autograd): the flops they record for the rest
    (``slstm_steps``, ``mlstm_chunks``) make the trace's count the whole
    loops' (``FlopCounterMode`` on a CPU run of the same call), forward and
    backward."""
    b = t_reg.get("xlstm-125m")
    cfg = b.smoke
    fam_params, _ = t_reg.abstract_params(b, cfg)
    cpu_params, _ = t_reg.init_fn(b)(cfg, seed=0, device="cpu")
    seq = 2 * 128                                   # two mLSTM chunks
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, seq))
                            .astype(np.int32))
    if train:
        step = make_train_step(t_reg.train_loss_fn(b, cfg), opt.OptConfig())
        rec = t_dry.measure(lambda: step(fam_params, opt.init(fam_params),
                                         {"tokens": toks.to("meta")}))
        with FlopCounterMode(display=False) as fcm:
            step(cpu_params, opt.init(cpu_params), {"tokens": toks})
    else:
        from repro_torch.train.serve_step import serve_family

        fam = serve_family(b.kind)
        rec = t_dry.measure(lambda: fam.prefill(fam_params, {"tokens": toks.to("meta")}, cfg,
                                                seq), inference=True)
        with torch.inference_mode(), FlopCounterMode(display=False) as fcm:
            fam.prefill(cpu_params, {"tokens": toks}, cfg, seq)
    assert set(rec["kernels"]) == {"slstm_steps"} | (set() if train else {"mlstm_chunks"})
    assert rec["torch_flops"] + rec["kernel_flops"] == fcm.get_total_flops()


def test_a_k9_site_adds_only_its_output():
    q = torch.empty((2, 8, 256, 64), dtype=torch.bfloat16, device="meta")
    k, v = (torch.empty((2, 2, 256, 64), dtype=torch.bfloat16, device="meta") for _ in "kv")
    rec = t_dry.measure(lambda: fa.flash_fwd(q, k, v, causal=True))
    assert rec["transient_peak"] == rec["transient_end"] == q.numel() * 2
    assert rec["torch_flops"] == 0
    assert rec["kernels"] == {"flash_fwd": {
        "calls": 1, "flops": 4 * 2 * 8 * 64 * (256 * 257 // 2),
        "bytes": 2 * (2 * q.numel() + 2 * k.numel())}}
    assert bounds.flash_flops(1, 1, 5, 3, 1) == 4 * (1 + 2 + 3 + 3 + 3)


def _meta(*tensors):
    return [t.to("meta") for t in tensors]


def _ints(rng, hi, shape):
    return torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))


def _bag_cases():
    """(name, wrapper, its CPU args, keyword args) of every kernel wrapper."""
    rng = np.random.default_rng(0)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    g, k, dim = 6, 3, 16
    q, r, c = f(40, dim), f(5, dim), f(4, dim)
    qi, ri, slot = _ints(rng, 40, (g, k)), _ints(rng, 5, (g, k)), _ints(rng, 4, (g, k)) - 2
    d1, d2, d3, rank = 2, 4, 2, 3
    g1, g2, g3 = f(7, d1 * rank), f(9, rank * d2 * rank), f(5, rank * d3)
    gc_ = f(4, rank * d2 * rank)
    i1, i2, i3 = _ints(rng, 7, (g, k)), _ints(rng, 9, (g, k)), _ints(rng, 5, (g, k))
    h = f(2, 4, 33, 32)
    kv = f(2, 2, 33, 32)
    return [
        ("packed_qr_bag", pg.packed_qr_bag, (q, c, r, qi, slot, ri), {"tables": 2}),
        ("packed_bag", pg.packed_bag, (q, c, qi, slot), {"tables": 3}),
        ("packed_tt_bag", pg.packed_tt_bag, (g1, g2, g3, gc_, i1, i2, i3, slot),
         {"dims": (d1, d2, d3, rank)}),
        ("tt_bag", tg.tt_bag, (g1, g2, g3, i1, i2, i3), {"dims": (d1, d2, d3, rank)}),
        ("cached_bag", cg.cached_bag, (q, c, qi, slot), {}),
        ("cached_qr_bag", cg.cached_qr_bag, (q, c, r, qi, slot, ri), {}),
        ("gnr_bag", gb.gnr_bag, (q, r, qi, ri), {}),
        ("gnr_bag_dense", gb.gnr_bag_dense, (q, qi), {}),
        ("qr_gather", qg.qr_gather, (q, r, qi.reshape(-1), ri.reshape(-1)), {}),
        ("flash_fwd", fa.flash_fwd, (h, kv, kv.clone()), {"causal": True}),
    ]


@pytest.mark.parametrize("case", range(10))
def test_meta_wrappers_give_the_kernels_outputs_and_never_the_plain_version(case, monkeypatch):
    name, fn, args, kw = _bag_cases()[case]
    want = fn(*args, **kw)                                  # the plain version on the CPU
    for mod in (pg, tg, cg, gb, qg, fa, ref):
        for attr in dir(mod):
            if attr.endswith("_ref"):
                monkeypatch.setattr(mod, attr, lambda *a, **k: pytest.fail("plain version ran"))
    launches = {m.__name__: dict(m.LAUNCHES) for m in (pg, tg, cg, gb, qg, fa)}
    bounds.reset_meta()
    got = fn(*_meta(*args), **kw)
    assert got.device.type == "meta"
    assert got.shape == want.shape and got.dtype == want.dtype
    assert launches == {m.__name__: dict(m.LAUNCHES) for m in (pg, tg, cg, gb, qg, fa)}
    assert list(bounds.META) == [name] and bounds.META[name][0] == 1
    assert bounds.META[name][1] > 0 and bounds.META[name][2] > 0
    bounds.reset_meta()


def test_meta_recompute_with_sinks_raises():
    q, r = torch.empty((9, 4), device="meta", requires_grad=True), torch.empty((3, 4), device="meta")
    qi = torch.empty((6,), dtype=torch.int32, device="meta")
    out = ops.qr_lookup(q, r, qi, qi, sinks={"q_idx": 8})
    with pytest.raises(ValueError, match="sinks on meta"):
        out.sum().backward()


def test_meta_collectives_count_what_gloo_counts(tmp_path):
    import torch_dryrun_ranks as R

    real = M.spawn(R.step_sites, (1, 2), axes=("data", "model"), device="cpu", backend="gloo",
                   init_file=tmp_path / "rdv", timeout_s=240)
    b = t_reg.get(R.ARCH)
    for shard, want in enumerate(real):
        mesh = M.abstract_mesh((1, 2), ("data", "model"), (0, shard))
        got = t_dry.trace_train(b, b.smoke, R.BATCH, R.SEQ, mesh=mesh)["sites"]
        assert got == dict(sorted(want.items(), key=str)), shard
        assert {"combine/model", "entry/model", "loss/model", "pmax/model"} <= set(got)
    # a (2, 2) step trains FSDP over ``data``: the meta trace counts the
    # gloo ranks' gathers and reduce-scatters, calls and bytes, exactly
    real = M.spawn(R.step_sites, (2, 2), axes=("data", "model"), device="cpu", backend="gloo",
                   init_file=tmp_path / "rdv22", timeout_s=240)
    for rank, want in enumerate(real):
        mesh = M.abstract_mesh((2, 2), ("data", "model"), divmod(rank, 2))
        got = t_dry.trace_train(b, b.smoke, R.BATCH, R.SEQ, mesh=mesh)["sites"]
        assert got == dict(sorted(want.items(), key=str)), rank
        assert {"fsdp_gather/data", "fsdp_scatter/data", "grad_mean/data"} <= set(got)
        assert got["fsdp_gather/data"][0] >= got["fsdp_scatter/data"][0] > 0


def test_lower_cell_on_the_card_and_the_pod():
    rec = t_dry.lower_cell("qwen2-1.5b", "prefill_32k", mesh="card")
    assert rec["status"] == "run" and rec["chips"] == 1
    m = rec["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["transient_peak_bytes"]
    assert m["hbm_bytes"] == int(M.HBM_PER_CHIP) and m["fits"] == (m["peak_bytes"] <= 80e9)
    assert rec["kernels"]["flash_fwd"]["calls"] == 28
    assert rec["flops"]["counted"] == rec["flops"]["torch"] + rec["flops"]["kernels"]
    assert rec["model_flops"] == 2 * rec["params_active"] * 32 * 32768
    # the prefix models' pod1 cells run and trace (cut to 2 layers a stack
    # and one microbatch where the trace would take minutes at full depth on
    # a CPU)
    whisper2 = {"enc_layers": 2, "dec_layers": 2, "num_layers": 4}
    for arch, shape, cut in (("pixtral-12b", "train_4k", {"num_layers": 2}),
                             ("whisper-large-v3", "train_4k", whisper2),
                             ("pixtral-12b", "prefill_32k", {"num_layers": 2}),
                             ("whisper-large-v3", "decode_32k", whisper2)):
        rec = t_dry.lower_cell(arch, shape, mesh="pod1", extra_cfg=cut, microbatches=1)
        assert rec["status"] == "run" and len(rec["ranks"]) == 2, rec["status"]
        assert rec["memory"]["fits"] and rec["collectives"]["combine/model"][0] > 0
        assert ("entry/model" in rec["collectives"]) == (shape == "train_4k")
    rec = t_dry.lower_cell("zamba2-7b", "prefill_32k", mesh="pod1")
    assert rec["status"] == "run" and len(rec["ranks"]) == 2
    assert rec["collectives"]["norm_stat/model"][0] > 0
    rec = t_dry.lower_cell("qwen2-1.5b", "decode_32k", mesh="pod1")
    assert rec["status"] == "run" and rec["chips"] == 256
    assert [r["coords"] for r in rec["ranks"]] == [{"data": 0, "model": 0},
                                                   {"data": 0, "model": 15}]
    m = rec["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["transient_peak_bytes"] > m["cache_bytes"]
    assert rec["collectives"]["logits/model"][0] == 1
    rec = t_dry.lower_cell("qwen2-1.5b", "prefill_32k", extra_cfg={"flash_block_dtype": "bf16"})
    assert rec["status"] == "run"                  # K9's bf16 probability tile


def test_fit_takes_the_largest_size_that_fits_and_confirms_it():
    calls = []

    def predict(n):                    # linear to 10, then steeper
        calls.append(n)
        return 100 + 10 * n + (0 if n <= 10 else 50 * (n - 10))

    got = t_dry.fit(predict, 260, (1, 2))
    assert got["size"] == 11 and got["predicted"] == 260 and calls[:3] == [1, 2, 16]
    assert all(predict(n) > 260 for n in (12, 16))
    assert t_dry.fit(predict, 150, (1, 2), cap=3)["size"] == 3
    assert t_dry.fit(predict, 10, (1, 2))["size"] == 1


def test_resolve_takes_meta_only_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve(None)
    with pytest.raises(RuntimeError):
        device_mod.resolve("cuda")
    assert device_mod.resolve("meta") == torch.device("meta")
    assert device_mod.resolve("cpu") == torch.device("cpu")
    assert device_mod.of(torch.empty(1, device="meta")).type == "meta"
    assert device_mod.generator(torch.device("meta")).device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported"):
        device_mod.resolve("xpu")
