"""splitmix32 of the PyTorch port (int64 tensors holding uint32 values)
against the pinned Python mixer and the JAX package's uint32 version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from game_engine_tpu.core.step import splitmix32_jax
from game_engine_tpu.gamespec.mechanics import splitmix32 as splitmix32_py
from game_engine_tpu_torch.core.step import mul32, splitmix32

SEEDS = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
# the auto-reset reseed input is seed ^ 0xDECAF000
CASES = SEEDS + [s ^ 0xDECAF000 for s in SEEDS]


@pytest.mark.parametrize("x", CASES, ids=[f"{x:#010x}" for x in CASES])
def test_splitmix32_matches_python_and_jax(x):
    got = int(splitmix32(torch.tensor([x], dtype=torch.int64))[0])
    via_jax = int(np.asarray(splitmix32_jax(jnp.asarray(np.uint32(x)))))
    assert got == splitmix32_py(x) == via_jax


def test_splitmix32_vectorized():
    xs = np.random.default_rng(0).integers(0, 2 ** 32, size=4096, dtype=np.int64)
    got = splitmix32(torch.as_tensor(xs)).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2 ** 32
    assert [int(v) for v in got] == [splitmix32_py(int(x)) for x in xs]


@pytest.mark.parametrize("c", [0x9E3779B9, 0x85EBCA6B, 0x100, 0xFFFFFFFF])
def test_mul32_is_uint32_product(c):
    xs = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 123456789], np.int64)
    got = mul32(torch.as_tensor(xs), c).tolist()
    assert got == [(int(x) * c) & 0xFFFFFFFF for x in xs]
