"""The port's attention against the JAX package's.

On the CPU ``ops.flash_attention`` runs its plain PyTorch version
(``attention_ref``).  It is held against the JAX package's dense
``attention_ref``, its Pallas kernel in interpret mode and the model's own
attention ``_attend`` with ``causal_mask_bias`` / ``_decode_mask_bias``,
over the JAX package's sweeps (tests/test_kernels.py,
tests/test_kernel_model_consistency.py), with head padding and decode
steps that sit anywhere in the cache.  Tolerances are the JAX tests' own:
2e-6 in float32 and 2e-2 in bfloat16 against the dense reference, 3e-5
against the model's attention.  The CUDA kernel is held against the plain
version on the card in tests/test_torch_gpu.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced_config
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models.layers import _attend, causal_mask_bias
from repro.models.model import _decode_mask_bias
from repro_torch.kernels import native
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, flash_attention

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(b, sq, sk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for s, n in ((sq, h), (sk, hkv), (sk, hkv))]


def _both(arrays, dtype):
    """The same numpy inputs as torch tensors and as JAX arrays of dtype."""
    return ([torch.from_numpy(a).to(dtype) for a in arrays],
            [jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 128)])
def test_sweep_matches_jax_reference(dtype, causal, window):
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 256, 256, 4, 2, 64, 0), dtype)
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    want = jax_ref(jq, jk, jv, causal=causal, window=window)
    _close(got, want, 2e-6 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 64)])
def test_block_sweep_matches_pallas_kernel(blocks):
    """Against the Pallas kernel itself (interpret mode), whose tiling the
    port's kernel need not share."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(1, 256, 256, 2, 1, 32, 1),
                                    torch.float32)
    want = jax_flash(jq, jk, jv, block_q=blocks[0], block_k=blocks[1])
    _close(flash_attention(q, k, v), want, 2e-6)


def test_decode_end_aligned_matches_jax_reference():
    """Sq = 1 against 200 keys, the default alignment (row at Sk - Sq)."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 1, 200, 4, 2, 32, 2),
                                    torch.float32)
    _close(flash_attention(q, k, v, causal=True),
           jax_ref(jq, jk, jv, causal=True), 1e-6)


def _cfg(h, kv, window):
    return dataclasses.replace(reduced_config(ARCHS["granite-3-8b"]),
                               dtype="float32", n_heads=h, n_kv_heads=kv,
                               head_dim=32, sliding_window=window)


@pytest.mark.parametrize("h,kv", [(4, 2), (8, 2), (4, 4)])
@pytest.mark.parametrize("window", [None, 64])
def test_matches_model_attention(h, kv, window):
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 256, 256, h, kv, 32, 0),
                                    torch.float32)
    want = _attend(jq, jk, jv, causal_mask_bias(256, 256, window, 0),
                   _cfg(h, kv, window))
    _close(flash_attention(q, k, v, causal=True, window=window, q_offset=0),
           want, 3e-5)


def test_matches_model_attention_with_head_padding():
    """Zero-padded q heads (6 heads on 2 kv heads) flow through both."""
    arrays = _inputs(1, 128, 128, 6, 2, 32, 1)
    arrays[0][:, :, 4:] = 0.0
    (q, k, v), (jq, jk, jv) = _both(arrays, torch.float32)
    want = _attend(jq, jk, jv, causal_mask_bias(128, 128, None, 0),
                   _cfg(6, 2, None))
    _close(flash_attention(q, k, v, causal=True, q_offset=0), want, 3e-5)


@pytest.mark.parametrize("index", [0, 5, 63, 127])
def test_decode_step_matches_model_decode_mask(index):
    """A decode step attends the whole 128-slot cache with ``q_offset`` =
    the token's position: slots past it (still zeros in the model's cache)
    are masked, as ``_decode_mask_bias`` masks them."""
    arrays = _inputs(1, 1, 128, 8, 2, 32, index)
    arrays[1][:, index + 1:] = 0.0
    arrays[2][:, index + 1:] = 0.0
    (q, k, v), (jq, jk, jv) = _both(arrays, torch.float32)
    cfg = _cfg(8, 2, None)
    want = _attend(jq, jk, jv, _decode_mask_bias(cfg, 128, index), cfg)
    _close(flash_attention(q, k, v, causal=True, q_offset=index), want, 3e-5)
    if index < 127:      # end alignment would attend the zero slots
        end = flash_attention(q, k, v, causal=True)
        assert not torch.allclose(end, torch.from_numpy(np.array(want)),
                                  atol=1e-3)


def test_rows_that_see_no_key_are_zero():
    """A zero denominator gives 0, as the kernel's skipped rows do."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 5, 3, 2, 1, 32, 3))
    out = flash_attention(q, k, v, causal=True, q_offset=-2)
    assert not out[:, :2].any() and out[:, 2:].abs().sum() > 0
    full = flash_attention(q[:, 2:], k, v, causal=True, q_offset=0)
    torch.testing.assert_close(out[:, 2:], full)


def test_cpu_never_launches_and_other_devices_refuse():
    native.reset_launches()
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 2, 1, 32, 4))
    flash_attention(q, k, v)
    assert native.LAUNCHES["flash_attention"] == 0
    meta = torch.empty((1, 4, 2, 32), device="meta")
    with pytest.raises(ValueError):
        flash_attention(meta, meta[:, :, :1], meta[:, :, :1])
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHS.items()
                                         if c.family != "ssm"))
def test_kernel_takes_every_attention_head_dim(arch, reduced):
    """The kernel's head dims cover every config with attention layers
    (xLSTM, the ssm family, has none), full and reduced: a model of the
    repo never reaches the wrapper's refusal."""
    cfg = reduced_config(ARCHS[arch]) if reduced else ARCHS[arch]
    assert cfg.head_dim in HEAD_DIMS
