"""Port parity for the native fastloader binding (``data/native.py``).

Each of the four functions of the port's binding against the JAX package's
on the same seeded arrays: with the library, and with the numpy fallback
(``_lib = None`` in both modules), exactly; the library's resize against
the fallback's within one level, as ``tests/test_native.py`` holds it.
"""

import contextlib

import numpy as np
import pytest

from pyramid_flow_tpu.data import native as jnative
from pyramid_flow_tpu_torch.data import native

MODES = ["library", "numpy"]


@contextlib.contextmanager
def mode(name):
    """Both bindings with their library (``library``) or without it."""
    assert native.available() and jnative.available(), \
        "native/libfastloader.so should load (native/build.sh builds it)"
    saved = native._lib, jnative._lib
    if name == "numpy":
        native._lib = jnative._lib = None
    try:
        yield
    finally:
        native._lib, jnative._lib = saved


def _image(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


@pytest.mark.parametrize("name", MODES)
def test_resize_matches_jax(name):
    img = _image(0, (37, 53, 3))
    with mode(name):
        for oh, ow in ((24, 40), (64, 80), (37, 53)):
            got = native.resize_bilinear_u8(img, oh, ow)
            assert got.shape == (oh, ow, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(
                got, jnative.resize_bilinear_u8(img, oh, ow))


def test_resize_library_within_one_level_of_numpy():
    img = _image(1, (48, 64, 3))
    with mode("library"):
        lib = native.resize_bilinear_u8(img, 30, 50)
    with mode("numpy"):
        ref = native.resize_bilinear_u8(img, 30, 50)
    assert np.abs(lib.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("name", MODES)
def test_normalize_matches_jax(name):
    img = _image(2, (5, 7, 3))
    with mode(name):
        got = native.u8_to_f32_norm(img)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jnative.u8_to_f32_norm(img))


@pytest.mark.parametrize("name", MODES)
def test_crop_resize_norm_matches_jax(name):
    img = _image(3, (48, 64, 3))
    with mode(name):
        for args in ((32, 32, 0, 3), (24, 30, 0, 1)):
            got = native.crop_resize_norm(img, *args)
            assert got.shape == (args[0], args[1], 3)
            np.testing.assert_array_equal(
                got, jnative.crop_resize_norm(img, *args))


@pytest.mark.parametrize("name", MODES)
def test_batch_load_npy_matches_jax(tmp_path, name):
    rng = np.random.default_rng(4)
    shape = (3, 4, 4, 2)
    paths = []
    for i in range(5):
        arr = rng.standard_normal(shape).astype(
            np.float32 if i % 2 else np.float16)
        paths.append(str(tmp_path / f"a{i}.npy"))
        np.save(paths[-1], arr)
    with mode(name):
        got = native.batch_load_npy(paths, shape, num_threads=4)
        assert got.shape == (5,) + shape and got.dtype == np.float32
        np.testing.assert_array_equal(
            got, jnative.batch_load_npy(paths, shape, num_threads=4))
