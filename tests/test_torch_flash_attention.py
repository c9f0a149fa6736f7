"""The port's flash attention against the JAX package.

The plain PyTorch version ``flash_attention_torch`` is held against the
Pallas kernel (``repro.kernels.ops.flash_attention``, interpret mode on
the CPU) and the ``ref.flash_attention_ref`` oracle at the shapes of
``tests/test_kernels.py::TestFlashAttention`` and at the head layouts
of stablelm-12b, nemotron-4-340b and recurrentgemma-9b, in float32
(tolerance 2e-5) and bfloat16 (2e-2, the JAX suite's tolerances: bf16
keeps 8 significant bits and the two sides round the output and the
probabilities at different points). The port's
``attend`` is held against the JAX ``attend``, chunked path included.
Inputs are drawn with numpy and rounded to the working type the same
way on both sides. The CUDA kernel is held against the plain version
on the card in ``tests/test_torch_kernels_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

# (B, Sq, Skv, H, KV, hd, causal, window, softcap): the JAX suite's shapes
SHAPES = [
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 128, 256, 4, 1, 128, True, 0, 0.0),     # offset queries
    (2, 256, 256, 8, 8, 64, True, 64, 0.0),     # MHA + window
    (1, 256, 256, 2, 1, 64, False, 0, 0.0),     # bidirectional
    (1, 128, 128, 4, 2, 64, True, 0, 30.0),     # softcap
    (2, 300, 300, 4, 2, 64, True, 0, 0.0),      # padded
    (1, 100, 260, 4, 4, 32, True, 48, 0.0),     # padded + window
]
STABLELM = (1, 256, 256, 32, 8, 160, True, 0, 0.0)   # G = 4, hd 160
# the card kernel's other serving head layouts: nemotron-4-340b (G 12,
# hd 192) and recurrentgemma-9b (MQA G 16, hd 256, local window)
WIDE_HEADS = [(1, 256, 256, 24, 2, 192, True, 0, 0.0),
              (1, 256, 256, 16, 1, 256, True, 128, 0.0)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def make_qkv(B, Sq, Skv, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), np.float32),
            rng.standard_normal((B, Skv, KV, hd), np.float32),
            rng.standard_normal((B, Skv, KV, hd), np.float32))


def both(arrays, dtype):
    """The same values as JAX arrays and torch tensors of one type."""
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def check_plain_against_jax(shape, dtype, seed):
    B, Sq, Skv, H, KV, hd, causal, window, cap = shape
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(B, Sq, Skv, H, KV, hd, seed),
                                      dtype)
    out = tfa.flash_attention_torch(tq, tk, tv, causal=causal,
                                    window=window, softcap=cap)
    assert out.dtype == tq.dtype and tuple(out.shape) == (B, Sq, H, hd)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  softcap=cap)
    ref = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                   softcap=cap)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(f32(out), f32(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_ref(shape, dtype):
    check_plain_against_jax(shape, dtype, seed=sum(shape[:6]))


def test_plain_matches_pallas_at_stablelm_heads():
    check_plain_against_jax(STABLELM, "float32", seed=12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", WIDE_HEADS)
def test_plain_matches_pallas_at_wide_heads(shape, dtype):
    check_plain_against_jax(shape, dtype, seed=shape[5])


def test_ops_dispatch_on_cpu_is_the_plain_version():
    """CPU tensors take the plain version, count no launch, and the
    CUDA wrapper refuses them."""
    _, (q, k, v) = both(make_qkv(1, 100, 260, 4, 2, 32, 3), "float32")
    before = dict(tops.LAUNCHES)
    out = tops.flash_attention(q, k, v, causal=True, window=48)
    assert torch.equal(out, tfa.flash_attention_torch(q, k, v, causal=True,
                                                      window=48))
    assert tops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)


def test_noncausal_ragged_lengths_raise_like_jax():
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(1, 100, 100, 2, 1, 32, 4),
                                      "float32")
    with pytest.raises(ValueError, match="block-aligned"):
        jops.flash_attention(jq, jk, jv, causal=False)
    with pytest.raises(ValueError, match="block-aligned"):
        tops.flash_attention(tq, tk, tv, causal=False)


def test_launch_counts_are_one_dict_over_all_kernels():
    from repro_torch.kernels import build
    assert tops.LAUNCHES is build.LAUNCHES
    assert set(tops.LAUNCHES) == set(build.KERNELS) == {
        "schedule_step", "flash_attention", "ssd_chunk", "lru_scan"}
    assert "-fmad=false" in build.flags("schedule_step")
    for name in ("flash_attention", "ssd_chunk", "lru_scan"):
        assert "-fmad=false" not in build.flags(name)


@pytest.mark.parametrize("Sq,q_chunk", [(128, 32), (100, 32), (64, 1024)])
def test_attend_matches_jax_attend(Sq, q_chunk):
    """The plain path, chunked (JAX scans 4 chunks of 32 at Sq 128; the
    port also chunks the ragged Sq 100, where JAX does not) and
    unchunked, with a (B, Sq, Skv) mask."""
    B, Skv, H, KV, hd = 2, Sq, 8, 2, 32
    (jq, jk, jv), (tq, tk, tv) = both(make_qkv(B, Sq, Skv, H, KV, hd, Sq),
                                      "float32")
    mask = np.asarray(jcommon.causal_mask(Sq, Skv, window=40))
    mask = np.broadcast_to(mask, (B, Sq, Skv)).copy()
    mask[1, :, :3] = False
    want = jattn.attend(jq, jk, jv, mask=jnp.asarray(mask), q_chunk=q_chunk,
                        softcap_val=20.0)
    got = tattn.attend(tq, tk, tv, mask=torch.from_numpy(mask),
                       q_chunk=q_chunk, softcap_val=20.0)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


def test_attend_with_hint_on_cpu_runs_the_plain_path():
    _, (q, k, v) = both(make_qkv(1, 64, 64, 4, 2, 16, 5), "float32")
    mask = tcommon.causal_mask(64, 64)
    before = dict(tops.LAUNCHES)
    hinted = tattn.attend(q, k, v, mask=mask, causal=True)
    assert tops.LAUNCHES == before
    assert torch.equal(hinted, tattn.attend(q, k, v, mask=mask))
    np.testing.assert_allclose(
        f32(hinted), f32(tfa.flash_attention_torch(q, k, v)), atol=2e-6)


def test_decode_mask_and_cache_update_match_jax():
    kv_pos = np.array([0, 1, 2, 7, -1, 5], np.int32)
    for window in (0, 4):
        want = jattn.decode_mask(jnp.int32(6), jnp.asarray(kv_pos), window)
        got = tattn.decode_mask(6, torch.from_numpy(kv_pos), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(6)
    k_l, v_l = (rng.standard_normal((2, 5, 2, 8), np.float32)
                for _ in range(2))
    nk, nv = (rng.standard_normal((2, 1, 2, 8), np.float32) for _ in range(2))
    jk, jv = jattn.update_layer_cache(jnp.asarray(k_l), jnp.asarray(v_l),
                                      jnp.asarray(nk), jnp.asarray(nv), 3)
    tk, tv = torch.from_numpy(k_l.copy()), torch.from_numpy(v_l.copy())
    rk, rv = tattn.update_layer_cache(tk, tv, torch.from_numpy(nk),
                                      torch.from_numpy(nv), 3)
    assert rk is tk and rv is tv           # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(IndexError, match="full"):
        tattn.update_layer_cache(tk, tv, torch.from_numpy(nk),
                                 torch.from_numpy(nv), 5)
