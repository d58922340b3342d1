"""The port's dense LM (``repro_torch.models``) against the JAX package's.

Reduced granite-3-8b (2 layers, d_model 64, 4 heads over 2 KV heads).
Parameters come from the JAX ``Model.init(PRNGKey(0))`` through
``convert.params_from_jax``; inputs from a numpy seed.  Tolerances, as a
bound on max |got - want| relative to max |want|: 1e-5 in float32 (the two
packages sum in different orders), 2e-2 in bfloat16 (8 mantissa bits, so
each of the few roundings on the way may differ by 2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import Model as RefModel
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import Model
from repro_torch.models import layers as L

F32_REL = 1e-5
BF16_REL = 2e-2
_REL = {"float32": F32_REL, "bfloat16": BF16_REL}


def _configs(**overrides):
    return (get_config("granite-3-8b").reduced(**overrides),
            ref_get_config("granite-3-8b").reduced(**overrides))


def _np(x):
    """A JAX or torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max |diff| {err} > {rel} * max |want| {scale}"


def _bundle(dtype="float32", **overrides):
    cfg, rcfg = _configs(param_dtype=dtype, activation_dtype=dtype, **overrides)
    rparams = RefModel(rcfg).init(jax.random.PRNGKey(0))
    return cfg, rcfg, params_from_jax(jax.device_get(rparams), device="cpu"), rparams


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def bundle(request):
    return (request.param, *_bundle(request.param))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 259, shape).astype(np.int32)


def _pair(a: np.ndarray, dtype: str):
    """The same numpy array as a torch tensor and a JAX array of ``dtype``."""
    return (torch.from_numpy(a).to(getattr(torch, dtype)),
            jnp.asarray(a, jnp.dtype(dtype)))


def _layer(params, rparams, name):
    """Layer 0's parameters of period 0 in both packages."""
    got = {k: v[0] for k, v in params["stack"]["layer0"][name].items()}
    want = jax.tree.map(lambda v: v[0], rparams["stack"]["layer0"][name])
    return got, want


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    x, rx = _pair(rng.normal(size=(2, 5, 64)).astype(np.float32) * 3, dtype)
    scale, rscale = _pair(rng.normal(size=64).astype(np.float32), dtype)
    _close(L.rmsnorm({"scale": scale}, x, 1e-5), RL.rmsnorm({"scale": rscale}, rx, 1e-5),
           _REL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    rng = np.random.default_rng(2)
    x, rx = _pair(rng.normal(size=(2, 7, 4, 16)).astype(np.float32), dtype)
    pos = rng.integers(0, 2000, (2, 7)).astype(np.int32)
    _close(L.rope_frequencies(16, 10000.0), RL.rope_frequencies(16, 10000.0), F32_REL)
    _close(L.apply_rope(x, torch.from_numpy(pos), 10000.0),
           RL.apply_rope(rx, jnp.asarray(pos), 10000.0), _REL[dtype])


def test_gqa_attention_prefill(bundle):
    dtype, cfg, rcfg, params, rparams = bundle
    p, rp = _layer(params, rparams, "attn")
    x, rx = _pair(np.random.default_rng(3).normal(size=(2, 9, 64)).astype(np.float32), dtype)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    out, (k, v) = L.attention(p, cfg, x, torch.from_numpy(pos.copy()))
    rout, (rk, rv) = RL.attention(rp, rcfg, rx, jnp.asarray(pos))
    for got, want in ((out, rout), (k, rk), (v, rv)):
        _close(got, want, _REL[dtype])


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("index", [0, 5, 11, 40])
def test_gqa_attention_decode(kv, index):
    """One token against a cache at ``index``; 40 is past the 12-row cache,
    where the write position is clamped and every key is admitted."""
    cfg, rcfg, params, rparams = _bundle("float32", kv_cache_dtype=kv)
    p, rp = _layer(params, rparams, "attn")
    rng = np.random.default_rng(4)
    x, rx = _pair(rng.normal(size=(2, 1, 64)).astype(np.float32), "float32")
    pos = np.full((2, 1), index, np.int32)
    cache = {k: v[0] for k, v in Model(cfg).init_cache(2, 12, device="cpu")["layer0"].items()}
    rcache = jax.tree.map(lambda v: v[0], RefModel(rcfg).init_cache(2, 12)["layer0"])
    # a cache already holding rows, the same in both
    for name in ("k", "v"):
        if kv == "int8":
            vals = rng.integers(-127, 128, cache[name].shape).astype(np.int8)
            scales = rng.uniform(0.001, 0.02, cache[name + "_scale"].shape).astype(np.float32)
            cache[name + "_scale"].copy_(torch.from_numpy(scales))
            rcache[name + "_scale"] = jnp.asarray(scales)
        else:
            vals = rng.normal(size=cache[name].shape).astype(np.float32)
        cache[name].copy_(torch.from_numpy(vals))
        rcache[name] = jnp.asarray(vals)
    out, new = L.attention(p, cfg, x, torch.from_numpy(pos), kv_cache=cache, cache_index=index)
    rout, rnew = RL.attention(rp, rcfg, rx, jnp.asarray(pos), kv_cache=rcache,
                              cache_index=jnp.int32(index))
    _close(out, rout, F32_REL)
    assert set(new) == set(rnew)
    for name in new:
        if new[name].dtype == torch.int8:
            # a value on a rounding edge may land one step apart
            assert np.abs(new[name].numpy().astype(int) - np.asarray(rnew[name], int)).max() <= 1
        else:
            _close(new[name], rnew[name], F32_REL)


def test_quantize_kv():
    x = np.random.default_rng(5).normal(size=(2, 6, 2, 16)).astype(np.float32)
    q, s = L.quantize_kv(torch.from_numpy(x))
    rq, rs = RL.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    _close(s, rs, F32_REL)
    assert np.abs(q.numpy().astype(int) - np.asarray(rq, int)).max() <= 1
    assert (q.numpy() == np.asarray(rq)).mean() > 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_causal_attention_at_512(dtype):
    """Two 256-query chunks, called directly (the attention routes to it
    only from 4096 positions)."""
    rng = np.random.default_rng(6)
    q, rq = _pair(rng.normal(size=(1, 512, 4, 16)).astype(np.float32), dtype)
    k, rk = _pair(rng.normal(size=(1, 512, 2, 16)).astype(np.float32), dtype)
    v, rv = _pair(rng.normal(size=(1, 512, 2, 16)).astype(np.float32), dtype)
    scale = 1.0 / np.sqrt(16)
    got = L._chunked_causal_attention(q, k, v, 2, scale, getattr(torch, dtype))
    want = RL._chunked_causal_attention(rq, rk, rv, 2, scale, jnp.dtype(dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, _REL[dtype])
    assert L._chunk_size(33024, 256) == RL._chunk_size(33024, 256)


def test_swiglu(bundle):
    dtype, cfg, rcfg, params, rparams = bundle
    p, rp = _layer(params, rparams, "ffn")
    x, rx = _pair(np.random.default_rng(7).normal(size=(2, 5, 64)).astype(np.float32), dtype)
    _close(L.swiglu(p, x), RL.swiglu(rp, rx), _REL[dtype])


def test_embed_and_unembed_with_padded_vocab():
    cfg, rcfg, params, rparams = _bundle("float32", vocab_size=300)
    assert cfg.padded_vocab == 512
    toks = _tokens(8, (2, 5))
    _close(L.embed(params["embedding"], torch.from_numpy(toks)),
           RL.embed(rparams["embedding"], jnp.asarray(toks)), F32_REL)
    x = np.random.default_rng(8).normal(size=(2, 5, 64)).astype(np.float32)
    got = L.unembed(params["embedding"], cfg, torch.from_numpy(x))
    want = RL.unembed(rparams["embedding"], rcfg, jnp.asarray(x))
    _close(got[..., :300], want[..., :300], F32_REL)
    assert (got[..., 300:] == -1e30).all() and (np.asarray(want[..., 300:]) == -1e30).all()
    assert int(got.argmax(-1).max()) < 300


# ---------------------------------------------------------------------------
# the Model facade
# ---------------------------------------------------------------------------


def test_logits_train_and_loss(bundle):
    dtype, cfg, rcfg, params, rparams = bundle
    toks = _tokens(9, (2, 16))
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1  # masked: read from the end of the vocab, weighted 0
    got = Model(cfg).logits_train(params, torch.from_numpy(toks))
    want = RefModel(rcfg).logits_train(rparams, jnp.asarray(toks))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, _REL[dtype])
    loss = Model(cfg).loss(params, torch.from_numpy(toks), torch.from_numpy(labels))
    rloss = RefModel(rcfg).loss(rparams, jnp.asarray(toks), jnp.asarray(labels))
    _close(loss, rloss, _REL[dtype])


def test_prefill_then_decode_steps(bundle):
    dtype, cfg, rcfg, params, rparams = bundle
    model, rmodel = Model(cfg), RefModel(rcfg)
    toks = _tokens(10, (2, 11))
    logits, cache = model.prefill(params, torch.from_numpy(toks), max_len=32)
    rlogits, rcache = rmodel.prefill(rparams, jnp.asarray(toks), max_len=32)
    _close(logits, rlogits, _REL[dtype])
    for name in ("k", "v"):
        _close(cache["layer0"][name], rcache["layer0"][name], _REL[dtype])
    step = _tokens(11, (2, 4))
    for i in range(4):
        index = 11 + i
        logits, cache = model.decode_step(params, torch.from_numpy(step[:, i : i + 1]), cache,
                                          index)
        rlogits, rcache = rmodel.decode_step(rparams, jnp.asarray(step[:, i : i + 1]), rcache,
                                             jnp.int32(index))
        _close(logits, rlogits, _REL[dtype])


def test_int8_cache_prefill_then_decode():
    cfg, rcfg, params, rparams = _bundle("float32", kv_cache_dtype="int8")
    toks = _tokens(12, (1, 9))
    logits, cache = Model(cfg).prefill(params, torch.from_numpy(toks), max_len=16)
    rlogits, rcache = RefModel(rcfg).prefill(rparams, jnp.asarray(toks), max_len=16)
    _close(logits, rlogits, F32_REL)
    assert cache["layer0"]["k"].dtype == torch.int8
    _close(cache["layer0"]["k_scale"], rcache["layer0"]["k_scale"], F32_REL)
    tok = _tokens(13, (1, 1))
    logits, _ = Model(cfg).decode_step(params, torch.from_numpy(tok), cache, 9)
    rlogits, _ = RefModel(rcfg).decode_step(rparams, jnp.asarray(tok), rcache, jnp.int32(9))
    # int8 rows a rounding step apart move the logits by a quantum's share
    _close(logits, rlogits, 1e-3)


def test_cache_path_equals_the_full_path():
    """Prefill L-1 tokens, decode the last at index L-1: the logits of a
    prefill of all L tokens (float32)."""
    cfg, _, params, _ = _bundle("float32")
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(14, (1, 13)))
    full, _ = model.prefill(params, toks, max_len=32)
    _, cache = model.prefill(params, toks[:, :-1], max_len=32)
    step, _ = model.decode_step(params, toks[:, -1:], cache, 12)
    _close(step, full, F32_REL)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_init_cache_shapes_and_dtypes(kv):
    cfg, rcfg = _configs(kv_cache_dtype=kv)
    got = Model(cfg).init_cache(3, 20, device="cpu")
    want = RefModel(rcfg).init_cache(3, 20)
    assert set(got) == set(want) == {"layer0"}
    for name, leaf in want["layer0"].items():
        t = got["layer0"][name]
        assert tuple(t.shape) == leaf.shape, name
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), name
        assert not t.any()


def test_init_cache_and_conversion_default_to_cuda(monkeypatch):
    cfg, rcfg = _configs()
    tree = jax.device_get(RefModel(rcfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg).init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(tree)


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", value


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_tree_matches_the_reference_layout(dtype):
    cfg, rcfg = _configs(param_dtype=dtype, activation_dtype=dtype)
    got = dict(_leaves(Model(cfg).init(torch.Generator().manual_seed(0))))
    want = dict(_leaves(jax.device_get(RefModel(rcfg).init(jax.random.PRNGKey(0)))))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(leaf.dtype), name
    again = dict(_leaves(Model(cfg).init(torch.Generator().manual_seed(0))))
    assert all(torch.equal(got[n], again[n]) for n in got)  # seeded


def test_params_from_jax_round_trip_is_bit_exact():
    for dtype in ("bfloat16", "float32"):
        _, rcfg = _configs(param_dtype=dtype, activation_dtype=dtype)
        tree = jax.device_get(RefModel(rcfg).init(jax.random.PRNGKey(0)))
        got = dict(_leaves(params_from_jax(tree, device="cpu")))
        wide = dict(_leaves(params_from_jax(tree, device="cpu", dtype=torch.float32)))
        for name, leaf in _leaves(tree):
            t = got[name]
            assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), name
            back = t.view(torch.int16).numpy() if dtype == "bfloat16" else t.numpy()
            bits = leaf.view(np.int16) if dtype == "bfloat16" else leaf
            np.testing.assert_array_equal(back, bits, err_msg=name)
            # widening to float32 is exact
            np.testing.assert_array_equal(wide[name].numpy(), leaf.astype(np.float32))

