"""The FAST CUDA kernel vs its plain PyTorch version, on the card.

Imports no JAX, so it runs where the card is:
    python -m pytest tests/test_torch_fast_cuda.py -m gpu -q
Without a CUDA device every test here skips.
"""
import pytest
import torch

from orbslam_jpminipc_torch.ops import fast, fast_cuda

torch.set_num_threads(2)

@pytest.mark.gpu
@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_cuda_kernel_matches_plain(threshold):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, w in [(480, 640), (400, 533), (161, 214), (134, 179), (97, 140)]:
        img = torch.randint(0, 256, (h, w), generator=gen, device="cuda").float()
        got = fast_cuda.fast_detect(img, threshold, 19)
        ref = fast.border_mask(fast.nonmax_3x3(fast.fast_score_map(img, threshold)), 19)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (h, w)
    before = fast_cuda.LAUNCHES
    assert torch.equal(fast.detect(img, threshold, border=19), got)  # CUDA -> kernel
    assert fast_cuda.LAUNCHES == before + 1
    with pytest.raises(ValueError):
        fast_cuda.fast_detect(img, 0.0)
    with pytest.raises(ValueError):
        fast_cuda.fast_detect(img.double(), threshold)
    with pytest.raises(ValueError):
        fast_cuda.fast_detect(img.t(), threshold)


LEVEL_SHAPES = [(480, 640), (400, 533), (333, 444), (278, 370),
                (231, 309), (193, 257), (161, 214), (134, 179)]


def _plain_levels(levels, fast_th, fast_min_th, border, cell):
    return [fast.cell_select(
        fast.border_mask(fast.nonmax_3x3(fast.fast_score_map(l, fast_min_th)), border),
        fast_th, cell) for l in levels]


def _test_levels(gen):
    """8 levels: strong corners on the left, weak ones (between the two
    thresholds) in the middle, flat on the right."""
    levels = []
    for h, w in LEVEL_SHAPES:
        img = torch.full((h, w), 128.0, device="cuda")
        a, b = w // 3, 2 * w // 3
        img[:, :a] = torch.randint(0, 256, (h, a), generator=gen, device="cuda").float()
        img[:, a:b] += torch.randint(-6, 7, (h, b - a), generator=gen, device="cuda").float()
        levels.append(img)
    return levels


@pytest.mark.gpu
@pytest.mark.parametrize("ths", [(20.0, 7.0), (7.0, 7.0)])
@pytest.mark.parametrize("cell", [32, 16])
def test_one_launch_matches_plain_and_eight_launches(ths, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fast_th, fast_min_th = ths
    levels = _test_levels(torch.Generator(device="cuda").manual_seed(1))
    before = fast_cuda.LAUNCHES
    got = fast_cuda.fast_level_scores(levels, fast_th, fast_min_th, 19, cell)
    assert fast_cuda.LAUNCHES == before + 1
    via_dispatch = fast.level_scores(levels, fast_th, fast_min_th, 19, cell)  # CUDA -> kernel
    assert fast_cuda.LAUNCHES == before + 2
    ref = _plain_levels(levels, fast_th, fast_min_th, 19, cell)
    one_by_one = [fast_cuda.fast_level_scores([l], fast_th, fast_min_th, 19, cell)[0]
                  for l in levels]
    assert fast_cuda.LAUNCHES == before + 2 + len(levels)
    lo = [fast_cuda.fast_detect(l, fast_min_th, 19) for l in levels]
    torch.cuda.synchronize()
    for g, d, r, o, l in zip(got, via_dispatch, ref, one_by_one, lo):
        assert g.shape == r.shape and g.is_contiguous()
        assert torch.equal(g, r) and torch.equal(d, r) and torch.equal(o, r)
        assert torch.equal(fast.cell_select(l, fast_th, cell), r)
    if fast_th > fast_min_th:
        # both arms of the cell vote: some corners survive only as low ones
        assert any(bool(((l > 0) & (g == 0)).any()) for g, l in zip(got, lo))
        assert any(bool(((l > 0) & (l + 1.0 <= fast_th) & (g > 0)).any())
                   for g, l in zip(got, lo))


@pytest.mark.gpu
def test_one_launch_orders_negative_values():
    """A level with negative intensities among the others: the kernel's
    integer keys must order them as the floats are ordered."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    levels = _test_levels(torch.Generator(device="cuda").manual_seed(2))
    levels.append(torch.rand((70, 99), device="cuda") * 200.0 - 100.0)
    ref = _plain_levels(levels, 20.0, 7.0, 19, 32)
    got = fast_cuda.fast_level_scores(levels, 20.0, 7.0, 19, 32)
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.gpu
def test_level_scores_rejects_bad_input_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    img = torch.zeros((64, 64), device="cuda")
    before = fast_cuda.LAUNCHES
    for levels, ths in (([img.double()], (20.0, 7.0)), ([img.t()[:, :32]], (20.0, 7.0)),
                        ([img], (20.0, 0.0)), ([img, img.cpu()], (20.0, 7.0))):
        with pytest.raises(ValueError):
            fast_cuda.fast_level_scores(levels, ths[0], ths[1], 19, 32)
    assert fast_cuda.LAUNCHES == before
