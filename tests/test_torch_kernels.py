"""The port's hand-written CUDA kernels against their plain PyTorch versions.

This file imports nothing of JAX, so it runs on the machine with the card,
which has no JAX:

    python -m pytest tests/test_torch_kernels.py -q

The tests marked ``cuda`` skip where there is no card.  On the card every
comparison is exact: K1's distances are integers, K2 copies float32 pixels.
"""

import re

import numpy as np
import pytest
import torch

from bundle_adjustment_tpu_torch import kernels
from bundle_adjustment_tpu_torch.ops import hamming_kernel, orb, orb_kernel

# Several pytest workers share the cores: more torch threads per worker
# only contend with each other (three times slower in all).
torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, n):
    return torch.as_tensor(
        rng.integers(0, 2 ** 32, size=(n, 8), dtype=np.uint64).astype(np.uint32).view(np.int32))


def _knn2_case(seed, n1, n2):
    """Random words with planted ties and invalid train slots."""
    rng = np.random.default_rng(seed)
    d1, d2 = _words(rng, n1), _words(rng, n2)
    if n2 > 1:
        d2[1::3] = d2[0::3][: len(d2[1::3])]
    d1[::4] = d2[torch.arange(0, n1, 4) % n2]
    d1[1::5] = d2[torch.arange(1, n1, 5) % n2] ^ (1 << 7)
    valid2 = torch.as_tensor(rng.random(n2) > 0.1)
    return d1, d2, valid2


def _gather_case(H, W, B, seed=3):
    rng = np.random.default_rng(seed)
    img = torch.as_tensor((rng.random((H, W)) * 255).astype(np.float32))
    sy = torch.as_tensor(rng.integers(0, H - 37 + 1, B).astype(np.int32))
    sx = torch.as_tensor(rng.integers(0, W - 37 + 1, B).astype(np.int32))
    sy[:20] = H - 37            # rows 37..39 of the window fall off the image
    sx[10:30] = W - 37
    sy[30:40] = 0
    sx[30:40] = 0
    return img, sy, sx


def test_every_kernel_has_a_source_that_names_what_it_replaces():
    for name, (source, entry, argtypes) in kernels.KERNELS.items():
        text = (kernels.SOURCE_DIR / source).read_text()
        assert re.search(r"Replaces: bundle_adjustment_tpu/ops/\w+_pallas\.py", text), name
        assert f'extern "C" int {entry}(' in text, name
        assert "What bounds it on this card" in text, name
        assert len(argtypes) == text.split(f"int {entry}(")[1].split(")")[0].count(",") + 1


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    kernels.reset_launches()
    d1, d2, valid2 = _knn2_case(0, 33, 47)
    for a, b in zip(hamming_kernel.knn2_fused(d1, d2, valid2),
                    hamming_kernel.knn2_plain(d1, d2, valid2)):
        assert torch.equal(a, b)
    img, sy, sx = _gather_case(60, 90, 50)
    assert torch.equal(orb_kernel.gather_patches40(img, sy, sx),
                       orb_kernel.gather_patches40_plain(img, sy, sx))
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(4000, 4000), (1237, 3001), (130, 200), (64, 1)])
def test_hamming_kernel_matches_plain_on_the_card(card, n1, n2):
    args = [x.to(card) for x in _knn2_case(n1 + n2, n1, n2)]
    before = kernels.LAUNCHES[hamming_kernel.NAME]
    out = hamming_kernel.knn2_fused(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[hamming_kernel.NAME] == before + 1
    for a, b in zip(out, hamming_kernel.knn2_plain(*args)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gather_kernel_matches_plain_on_the_card(card):
    """At the main path's shapes: eight pyramid levels of a 1280x720 frame
    with preset_video's per-level budgets, edge starts included."""
    budgets = orb.level_budgets(6400, 8, 1.2)
    H, W = 720, 1280
    for lvl, B in enumerate(budgets):
        s = 1.2 ** -lvl
        img, sy, sx = _gather_case(int(round(H * s)), int(round(W * s)), B, seed=lvl)
        args = [x.to(card) for x in (img, sy, sx)]
        out = orb_kernel.gather_patches40(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, orb_kernel.gather_patches40_plain(*args))
