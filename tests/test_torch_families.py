"""The port's MoE and SSM families (``models/{moe,ssm}.py``) and every
architecture of ``configs.ARCHS`` against the JAX package.

Parameters come from the JAX initialisers through
``convert.params_from_jax``; inputs from a numpy seed.  Tolerances, as a
bound on max |got - want| relative to max |want|: 1e-5 in float32, 2e-2 in
bfloat16 (``tests/test_torch_model.py`` says why).

Whole models are compared in float32 for all ten architectures, and in
bfloat16 for those without an MoE FFN.  The MoE in bfloat16 is compared on
the same inputs (``moe_apply``), not through a stack: expert routing (top-k
and capacity slots) is discontinuous, and the JAX package's compiled stack
already differs from its own layers run one by one by more than 2e-2 there
(one bfloat16 ulp upstream moves a token to another expert).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import moe as RM
from repro.models import ssm as RS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.models import flops, moe as M, ssm as S

from test_torch_model import _close, _leaves, _np

REL = {"float32": 1e-5, "bfloat16": 2e-2}
MOE_ARCHS = ["moonshot-v1-16b-a3b", "arctic-480b", "jamba-1.5-large-398b"]


def _configs(arch, dtype="float32", **overrides):
    kw = dict(param_dtype=dtype, activation_dtype=dtype, **overrides)
    return get_config(arch).reduced(**kw), ref_get_config(arch).reduced(**kw)


def _port_params(tree):
    return params_from_jax(jax.device_get(tree), device="cpu")


def _pair(a: np.ndarray, dtype: str):
    return torch.from_numpy(a).to(getattr(torch, dtype)), jnp.asarray(a, jnp.dtype(dtype))


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)).astype(np.float32)


def _tree_close(got, want, rel):
    for name, leaf in _leaves(jax.device_get(want)):
        node = got
        for key in name.split("/"):
            node = node[key]
        _close(node, leaf, rel)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape,same_tokens", [((2, 16), False), ((1, 2048), False),
                                               ((4, 1), False), ((1, 64), True)])
def test_moe_apply(arch, dtype, shape, same_tokens):
    """Random tokens (two dispatch groups at 2,048 tokens) and 64 equal
    tokens, which all pick the same experts and so overflow the capacity."""
    cfg, rcfg = _configs(arch, dtype)
    rp = RM.moe_init(jax.random.PRNGKey(1), rcfg)
    p = _port_params(rp)
    x = _normal(2, shape + (cfg.d_model,))
    if same_tokens:
        x[:] = x[:, :1]
        cap = RM._capacity(rcfg.moe, shape[0] * shape[1])
        assert shape[0] * shape[1] > cap  # every picked expert overflows
    got_x, want_x = _pair(x, dtype)
    got = M.moe_apply(p, cfg, got_x)
    want = RM.moe_apply(rp, rcfg, want_x)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, REL[dtype])
    if same_tokens:  # tokens past the capacity lose their experts
        out = _np(got)[0]
        assert np.abs(out[-1] - out[0]).max() > 0
    _close(M.aux_load_balance_loss(p, cfg, got_x), RM.aux_load_balance_loss(rp, rcfg, want_x),
           REL[dtype])


def test_moe_group_size_assert_is_the_references():
    cfg, rcfg = _configs("moonshot-v1-16b-a3b")
    p = _port_params(RM.moe_init(jax.random.PRNGKey(0), rcfg))
    x = torch.zeros((1, M.GROUP_SIZE + 1, cfg.d_model))
    with pytest.raises(AssertionError):
        M.moe_apply(p, cfg, x)
    assert M._capacity(cfg.moe, 1024) == RM._capacity(rcfg.moe, 1024)
    assert M._capacity(cfg.moe, 1) == RM._capacity(rcfg.moe, 1) == cfg.moe.top_k


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(12, 256), (64, 16), (2, 256), (256, 256)])
def test_mamba_forward_and_decode(dtype, s, chunk):
    """One chunk, four chunks of 16 (the state crosses chunks), a sequence
    shorter than the conv tail, and one full chunk of 256; then two decode
    steps from the final state."""
    cfg, rcfg = _configs("jamba-1.5-large-398b", dtype)
    rp = RS.mamba_init(jax.random.PRNGKey(3), rcfg)
    p = _port_params(rp)
    got_x, want_x = _pair(_normal(4, (2, s, cfg.d_model)), dtype)
    got, gstate = S.mamba_forward(p, cfg, got_x, chunk=chunk)
    want, wstate = RS.mamba_forward(rp, rcfg, want_x, chunk=chunk)
    _close(got, want, REL[dtype])
    _tree_close(gstate, wstate, REL[dtype])
    pad = cfg.ssm_conv - 1 - s
    if pad > 0:  # the conv tail of a short prompt, as the stacks' prefill pads it
        gstate["conv"] = torch.nn.functional.pad(gstate["conv"], (0, 0, pad, 0))
        wstate["conv"] = jnp.pad(wstate["conv"], ((0, 0), (pad, 0), (0, 0)))
    for step in range(2):
        got_u, want_u = _pair(_normal(10 + step, (2, 1, cfg.d_model)), dtype)
        got, gstate = S.mamba_decode_step(p, cfg, got_u, gstate)
        want, wstate = RS.mamba_decode_step(rp, rcfg, want_u, wstate)
        _close(got, want, REL[dtype])
        _tree_close(gstate, wstate, REL[dtype])


def test_mamba_chunk_assert_is_the_references():
    cfg, rcfg = _configs("jamba-1.5-large-398b")
    rp = RS.mamba_init(jax.random.PRNGKey(0), rcfg)
    x = np.zeros((1, 257, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        RS.mamba_forward(rp, rcfg, jnp.asarray(x))
    with pytest.raises(AssertionError):
        S.mamba_forward(_port_params(rp), cfg, torch.from_numpy(x))
    assert S.MAMBA_CHUNK == RS.MAMBA_CHUNK == 256


def test_mamba_chunk_scan_is_the_recurrence():
    """The doubling scan against h_t = dA_t h_{t-1} + dBx_t step by step."""
    rng = np.random.default_rng(5)
    for c in (1, 3, 16, 37):
        dA = torch.from_numpy(rng.uniform(0.5, 1.0, (2, c, 3, 4)))
        dBx = torch.from_numpy(rng.normal(0, 1, (2, c, 3, 4)))
        h0 = torch.from_numpy(rng.normal(0, 1, (2, 3, 4)))
        h_all, h_last = S._mamba_chunk_scan(h0, dA, dBx)
        h = h0
        for t in range(c):
            h = dA[:, t] * h + dBx[:, t]
            torch.testing.assert_close(h_all[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(h_last, h, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [17, 64, 128, 1])
def test_rwkv6_forward_and_decode(dtype, s):
    cfg, rcfg = _configs("rwkv6-3b", dtype)
    rp = RS.rwkv6_init(jax.random.PRNGKey(6), rcfg)
    p = _port_params(rp)
    # a decay bias nearer zero than the init's -6 makes the decay bite
    rp = dict(rp, decay_bias=jnp.full_like(rp["decay_bias"], -1.0))
    p["decay_bias"] = torch.full_like(p["decay_bias"], -1.0)
    got_x, want_x = _pair(_normal(7, (2, s, cfg.d_model)), dtype)
    got, gstate = S.rwkv6_forward(p, cfg, got_x)
    want, wstate = RS.rwkv6_forward(rp, rcfg, want_x)
    _close(got, want, REL[dtype])
    _tree_close(gstate, wstate, REL[dtype])
    for step in range(2):
        got_u, want_u = _pair(_normal(20 + step, (2, 1, cfg.d_model)), dtype)
        got, gstate = S.rwkv6_decode_step(p, cfg, got_u, gstate)
        want, wstate = RS.rwkv6_decode_step(rp, rcfg, want_u, wstate)
        _close(got, want, REL[dtype])
        _tree_close(gstate, wstate, REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_channel_mix(dtype):
    cfg, rcfg = _configs("rwkv6-3b", dtype)
    rp = RS.rwkv_channel_mix_init(jax.random.PRNGKey(8), rcfg)
    got_x, want_x = _pair(_normal(9, (2, 10, cfg.d_model)), dtype)
    _close(S.rwkv_channel_mix(_port_params(rp), got_x), RS.rwkv_channel_mix(rp, want_x),
           REL[dtype])


def test_rwkv6_prompt_of_65_raises_as_the_reference():
    """Pinned reference behaviour (ROADMAP.md section 3.7): a sequence longer
    than one 64-token chunk must be a multiple of it, so neither package
    prefills a 65-token prompt, while 64 and 128 go through."""
    cfg, rcfg = _configs("rwkv6-3b")
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    params = _port_params(rparams)
    for n, ok in ((64, True), (65, False), (127, False), (128, True)):
        toks = np.arange(n, dtype=np.int32)[None] % cfg.vocab_size
        if ok:
            _, cache = Model(cfg).prefill(params, torch.from_numpy(toks), max_len=n + 1)
            _, rcache = RefModel(rcfg).prefill(rparams, jnp.asarray(toks), max_len=n + 1)
            _tree_close(cache, rcache, REL["float32"])
            continue
        with pytest.raises(AssertionError):
            RefModel(rcfg).prefill(rparams, jnp.asarray(toks), max_len=n + 1)
        with pytest.raises(AssertionError):
            Model(cfg).prefill(params, torch.from_numpy(toks), max_len=n + 1)
    assert S.RWKV_CHUNK == RS.RWKV_CHUNK == 64


# ---------------------------------------------------------------------------
# every architecture
# ---------------------------------------------------------------------------


def _arch_dtypes():
    for arch in ARCHS:
        yield pytest.param(arch, "float32", id=f"{arch}-float32")
        if arch not in MOE_ARCHS:
            yield pytest.param(arch, "bfloat16", id=f"{arch}-bfloat16")


@pytest.mark.parametrize("arch,dtype", list(_arch_dtypes()))
def test_prefill_then_decode_matches_the_reference(arch, dtype):
    """As tests/test_arch_smoke.py drives the reference (B=2, S=12, the
    modality prefix where the arch has one), and against it: prefill
    logits and cache, then two decode steps."""
    cfg, rcfg = _configs(arch, dtype)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(1))
    params = _port_params(rparams)
    model, rmodel = Model(cfg), RefModel(rcfg)
    B, S_ = 2, 12
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)
    prefix = rprefix = None
    if cfg.prefix_len:
        prefix, rprefix = _pair(_normal(12, (B, cfg.prefix_len, cfg.d_model)), dtype)
    total = S_ + cfg.prefix_len
    logits, cache = model.prefill(params, torch.from_numpy(toks), total + 4, prefix)
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks), total + 4, rprefix)
    assert tuple(logits.shape) == (B, 1, cfg.padded_vocab)
    _close(logits[..., : cfg.vocab_size], rlogits[..., : cfg.vocab_size], REL[dtype])
    _tree_close(cache, rcache, REL[dtype])
    tok = np.asarray(jnp.argmax(rlogits[:, -1:], axis=-1)).astype(np.int32)
    for step in range(2):
        logits, cache = model.decode_step(params, torch.from_numpy(tok), cache, total + step)
        rlogits, rcache = rmodel.decode_step(rparams, jnp.asarray(tok), rcache,
                                             jnp.int32(total + step))
        assert tuple(logits.shape) == (B, 1, cfg.padded_vocab)
        assert not torch.isnan(logits).any()
        assert int(torch.argmax(logits[0, 0])) < cfg.vocab_size
        _close(logits[..., : cfg.vocab_size], rlogits[..., : cfg.vocab_size], REL[dtype])
        _tree_close(cache, rcache, REL[dtype])
        tok = np.asarray(jnp.argmax(rlogits[:, -1:], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_init_layout(arch):
    """``param_count`` equals the reference's and lands within 2x of the
    published size (as tests/test_arch_smoke.py asserts); the port's own
    init has the reference's leaves, shapes and dtypes, and carries the
    reference's float32 leaves (router, A_log, D, decay, bonus) bit-exact
    through ``params_from_jax``."""
    published_b = {
        "musicgen-large": 3.3, "jamba-1.5-large-398b": 398.0, "arctic-480b": 480.0,
        "moonshot-v1-16b-a3b": 16.0, "internvl2-76b": 76.0, "qwen1.5-32b": 32.0,
        "starcoder2-7b": 7.0, "granite-3-8b": 8.0, "phi4-mini-3.8b": 3.8,
        "rwkv6-3b": 3.0,
    }[arch]
    n = get_config(arch).param_count()
    assert n == ref_get_config(arch).param_count()
    assert published_b / 2 <= n / 1e9 <= published_b * 2
    assert get_config(arch).active_param_count() == ref_get_config(arch).active_param_count()
    for shape in flops.SHAPES:
        assert flops.model_flops(get_config(arch), shape) == pytest.approx(
            flops.model_flops(ref_get_config(arch), shape))

    cfg, rcfg = _configs(arch, "bfloat16")
    tree = jax.device_get(RefModel(rcfg).init(jax.random.PRNGKey(0)))
    want = dict(_leaves(tree))
    got = dict(_leaves(Model(cfg).init(torch.Generator().manual_seed(0))))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(leaf.dtype), name
    carried = dict(_leaves(params_from_jax(tree, device="cpu")))
    for name, leaf in want.items():
        t = carried[name]
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), name
        if leaf.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), leaf.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), leaf)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-3b"])
def test_init_cache_of_the_recurrent_mixers(arch):
    cfg, rcfg = _configs(arch, "bfloat16")
    got = Model(cfg).init_cache(3, 20, device="cpu")
    want = jax.device_get(RefModel(rcfg).init_cache(3, 20))
    want_leaves = dict(_leaves(want))
    got_leaves = dict(_leaves(got))
    assert set(got_leaves) == set(want_leaves)
    for name, leaf in want_leaves.items():
        t = got_leaves[name]
        assert tuple(t.shape) == leaf.shape, name
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), name
        assert not t.any()


def _cache_vs_full(model, params, toks):
    """(prefill of L-1 tokens then one decode step, prefill of all L)."""
    n = toks.shape[1]
    full, _ = model.prefill(params, toks, max_len=n)
    _, cache = model.prefill(params, toks[:, :-1], max_len=n)
    step, _ = model.decode_step(params, toks[:, -1:], cache, n - 1)
    return step, full


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _no_channel_shift(params):
    """RWKV's channel mix without its token shift (``shift_mix`` 0)."""
    cmix = params["stack"]["layer0"]["cmix"]
    if isinstance(cmix["shift_mix"], torch.Tensor):
        cmix["shift_mix"] = torch.zeros_like(cmix["shift_mix"])
    else:
        cmix["shift_mix"] = jnp.zeros_like(cmix["shift_mix"])
    return params


def _one_rank(cfg):
    """Top-1 routing with room for every token: each token its own slot."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, top_k=1,
                                                            capacity_factor=64.0))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b", "moonshot-v1-16b-a3b"])
def test_cache_path_equals_the_full_path(arch):
    """Prefill of L-1 = 63 tokens then one decode step against the prefill
    of all 64 (float32), where the reference's decode is consistent with
    its full path: RWKV's channel mix without its token shift (section
    3.8), the MoE routed to one expert with no overflow (section 3.9)."""
    cfg, _ = _configs(arch)
    if cfg.moe is not None:
        cfg = _one_rank(cfg)
    params = Model(cfg).init(torch.Generator().manual_seed(3))
    if arch == "rwkv6-3b":
        params = _no_channel_shift(params)
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, cfg.vocab_size, (1, 64)))
    step, full = _cache_vs_full(Model(cfg), params, toks)
    _close(step, full, REL["float32"])


def _drawn_cache_vs_full(arch, cfg_fn=lambda c: c, params_fn=lambda p: p):
    """The cache path's distance from the full path in both packages, on the
    reference's parameters (float32, L=64)."""
    cfg, rcfg = _configs(arch)
    cfg, rcfg = cfg_fn(cfg), cfg_fn(rcfg)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(3))
    params = params_fn(_port_params(rparams))
    rparams = params_fn(rparams)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, 64)).astype(np.int32)
    step, full = _cache_vs_full(Model(cfg), params, torch.from_numpy(toks))
    rstep, rfull = _cache_vs_full(RefModel(rcfg), rparams, jnp.asarray(toks))
    _close(step, rstep, REL["float32"])
    _close(full, rfull, REL["float32"])
    return _rel(step, full), _rel(rstep, rfull)


def test_rwkv_channel_shift_not_carried_is_the_references():
    """Pinned reference behaviour (ROADMAP.md section 3.8): the decode cache
    holds the time mix's last token but not the channel mix's, so decode
    mixes each token's channel input with zeros and the cache path leaves
    the full path by ~2e-2 of max |logit| -- in both packages alike.
    Without the channel shift the two paths agree."""
    got, want = _drawn_cache_vs_full("rwkv6-3b")
    assert got > 1e-2 and want > 1e-2 and abs(got - want) <= 1e-3 * want
    got, want = _drawn_cache_vs_full("rwkv6-3b", params_fn=_no_channel_shift)
    assert got <= REL["float32"] and want <= REL["float32"]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-1.5-large-398b"])
def test_moe_slot_collisions_are_the_references(arch):
    """Pinned reference behaviour (ROADMAP.md section 3.9): a pick at rank
    k > 0 counts earlier ranks' picks only up to its own token, so it can
    take the capacity slot a later token's lower-rank pick takes too; the
    two tokens' inputs then add in that slot.  A token's output depends on
    the other tokens of its group even with no overflow, and the cache path
    leaves the full path -- in both packages alike.  Top-1 routing has no
    collision."""
    cfg, rcfg = _configs(arch)
    moe = dataclasses.replace(cfg.moe, capacity_factor=64.0)
    cfg, rcfg = dataclasses.replace(cfg, moe=moe), dataclasses.replace(rcfg, moe=moe)
    rp = RM.moe_init(jax.random.PRNGKey(0), rcfg)
    p = _port_params(rp)
    x = _normal(14, (1, 8, cfg.d_model))
    together = M.moe_apply(p, cfg, torch.from_numpy(x))
    alone = torch.cat([M.moe_apply(p, cfg, torch.from_numpy(x[:, i : i + 1]))
                       for i in range(8)], dim=1)
    rtogether = RM.moe_apply(rp, rcfg, jnp.asarray(x))
    _close(together, rtogether, REL["float32"])
    assert _rel(together, alone) > 0.1
    got, want = _drawn_cache_vs_full(arch, cfg_fn=lambda c: dataclasses.replace(c, moe=moe))
    assert got > 0.1 and want > 0.1
    got, want = _drawn_cache_vs_full(arch, cfg_fn=_one_rank)
    assert got <= REL["float32"] and want <= REL["float32"]
