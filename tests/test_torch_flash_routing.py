"""Which flash_attention kernels a CUDA call runs, decided by dtype and head dim.

``variant_for`` picks the forward kernel, ``bwd_variant_for`` the backward's,
``writes_lse`` whether that forward saves the logsumexp its backward reads.
These are plain functions of (dtype, d), so they are held here without a
card: 16-bit heads of 64, 128 and 256 (gemma3-4b) take the wgmma kernels
both ways, the 16-bit heads of 16 and 32 (which the 128-byte swizzled tiles
do not take) the mma_sync forward and the CUDA-core backward, float32 the
CUDA-core kernels, and float32 at d 256 has no backward: the check that
``FlashAttentionFn`` and ``flash_attention_bwd`` run before any launch
refuses it.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa

HALF = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [64, 128, 256])
def test_16bit_wide_heads_run_wgmma_both_ways(dtype, d):
    assert fa.variant_for(dtype, d) == "wgmma"
    assert fa.bwd_variant_for(dtype, d) == "wgmma"
    assert fa.writes_lse(dtype, d)


@pytest.mark.parametrize("dtype", HALF)
@pytest.mark.parametrize("d", [16, 32])
def test_16bit_small_heads_stay_mma_sync_forward_cuda_core_backward(dtype, d):
    assert fa.variant_for(dtype, d) == "mma_sync"
    assert fa.bwd_variant_for(dtype, d) == "cuda_core_f32"
    assert not fa.writes_lse(dtype, d)


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_float32_stays_on_the_cuda_cores(d):
    assert fa.variant_for(torch.float32, d) == "cuda_core_f32"
    assert fa.bwd_variant_for(torch.float32, d) == "cuda_core_f32"
    assert not fa.writes_lse(torch.float32, d)


def test_no_mma_sync_backward_and_only_wgmma_reads_an_lse():
    assert fa.BWD_VARIANTS == ("cuda_core_f32", "wgmma")
    assert fa.LSE_VARIANTS == ("wgmma",)
    assert set(fa.bwd_launches_by_variant) == set(fa.BWD_VARIANTS)
    assert fa.WGMMA_HEAD_DIMS == (64, 128, 256) and fa.MMA_SYNC_HEAD_DIMS == (16, 32)
    # every forward variant a 16-bit head dim can reach is a key of the C codes
    assert {fa.variant_for(t, d) for t in HALF for d in fa.BWD_HEAD_DIMS} <= set(fa.VARIANTS)


@pytest.mark.parametrize("dtype,d,refused", [
    (torch.float32, 256, True),    # no float32 backward kernel at d 256
    (torch.bfloat16, 256, False),
    (torch.float16, 256, False),
    (torch.float32, 128, False),
    (torch.bfloat16, 96, True),    # no kernel takes d 96
])
def test_backward_check_refuses_what_no_kernel_takes(dtype, d, refused):
    q = torch.zeros((1, 4, 8, d), dtype=dtype)
    kv = torch.zeros((1, 2, 8, d), dtype=dtype)
    if refused:
        with pytest.raises(ValueError):
            fa._check_bwd(q, kv, kv, 0, 0)
    else:
        fa._check_bwd(q, kv, kv, 0, 0)


@pytest.mark.parametrize("s_q", [1, 37, 128, 300, 1000])
def test_lse_buffer_rows_take_whole_128_row_ctas(s_q):
    """The d-256 kernels read the logsumexp and D a 64-row stage at a time
    and their dQ CTAs hold 128 rows: the buffer's rows cover that."""
    lse = fa.lse_buffer(torch.zeros((2, 8, s_q, 256), dtype=torch.bfloat16))
    assert lse.dtype == torch.float32 and lse.shape[:2] == (2, 8)
    assert lse.shape[2] % fa.LSE_ROW_ALIGN == 0 and s_q <= lse.shape[2] < s_q + 128
