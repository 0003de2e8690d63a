"""The port's CUDA kernels against their plain PyTorch versions on the
card. Skipped without one. This file imports neither jax nor the JAX
package, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from naruto_tpu_torch.ops import kernels, segment


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,ka,kb", [(512, 8, 8), (4608, 8, 4), (4608, 2, 2),
                                     (493_568, 8, 8)])
def test_kernels_match_plain_on_card(gen, cuda_device, m, ka, kb):
    """K2 and K1 against their plain versions on the same card tensors.
    Both round each product to bf16 the same way; K2's f32 sums run in
    another order than the plain reduction, hence 1e-6 of max|ref|."""
    sa = torch.tensor(gen.normal(size=(m, ka)), dtype=torch.bfloat16,
                      device=cuda_device)
    sb = torch.tensor(gen.normal(size=(m, kb)), dtype=torch.bfloat16,
                      device=cuda_device)
    n0 = kernels.launch_counts()
    tot = kernels.chunk_totals(sa, sb)
    ref_tot = kernels.chunk_totals_plain(sa, sb)
    offs = torch.cumsum(ref_tot, 0) - ref_tot
    out = kernels.outer_cumsum(sa, sb, offs)
    ref = kernels.outer_cumsum_plain(sa, sb, offs)
    torch.cuda.synchronize()
    n1 = kernels.launch_counts()
    assert n1["chunk_totals"] == n0["chunk_totals"] + 1
    assert n1["outer_cumsum"] == n0["outer_cumsum"] + 1
    for got, want in ((tot, ref_tot), (out, ref)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-6, err


@pytest.mark.cuda
def test_wrapper_refuses_noncontiguous_on_card(cuda_device):
    sa = torch.zeros((512, 16), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.chunk_totals(sa[:, ::2], sa[:, :8].contiguous())


@pytest.mark.cuda
def test_segment_sum_on_card_matches_host(gen, cuda_device):
    """The same segment sum through the kernels on the card and through
    the plain versions on the host: identical sort and bf16 terms, f32
    sums in another order, so 2e-6 of max|cumsum|."""
    n, L, per, kb = 2000, 4, 4000, 8
    idx = (gen.integers(0, per, (n, L))
           + np.arange(L)[None, :] * per).astype(np.int32)
    frac = gen.uniform(0, 1, (n, L, 3)).astype(np.float32)
    b = gen.normal(size=(n, L * kb)).astype(np.float32)
    args = (torch.tensor(idx), torch.tensor(frac), torch.tensor(b))
    ref = segment.dense_segment_sum_outer_level_major_frac(*args, L * per)
    got = segment.dense_segment_sum_outer_level_major_frac(
        *(a.to(cuda_device) for a in args), L * per).cpu()
    scale = float(torch.cumsum(ref, 0).abs().max())
    assert float((got - ref).abs().max()) < 2e-6 * scale
