"""Port parity for the serving slice as a whole: make_infer_fn,
infer_image and transfer against the JAX package's
evals/export.make_infer_fn, evals/infer.infer_image and
evals/transfer.transfer, with ``use_pallas=True`` on the JAX side (its
Pallas kernels in interpret mode) and the port's kernel wrappers taking
their plain versions on the CPU. float32, tiny config.

Tolerances: logits and recon 1e-4 absolute (tens of f32 layers in
another sum order); heatmaps, landmarks and sigma 1e-5; seg labels
exactly equal.
"""

import numpy as np
import pytest
import torch

from partseg_tpu.evals.export import make_infer_fn as jax_make_infer_fn
from partseg_tpu.evals.infer import infer_image as jax_infer_image
from partseg_tpu.evals.transfer import transfer as jax_transfer
from partseg_tpu_torch.evals import infer_image, make_infer_fn, transfer, transfer_batch
from _torch_parity import images, jax_partnet, n, torch_partnet

torch.set_num_threads(1)

TOL = {"logits": 1e-4, "heatmaps": 1e-5, "landmarks": 1e-5, "sigma": 1e-5}


@pytest.fixture(scope="module")
def pair():
    jm, jp = jax_partnet(use_pallas=True)
    return jm, jp, torch_partnet(jp)


def test_make_infer_fn_matches(pair):
    jm, jp, tm = pair
    x = images(0, 3, 32)
    want = jax_make_infer_fn(jm, jp)(x)
    got = make_infer_fn(tm)(x)
    assert set(got) == set(want) == {"heatmaps", "logits", "landmarks", "sigma", "seg"}
    for key, atol in TOL.items():
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(n(got[key]), np.asarray(want[key]), atol=atol, err_msg=key)
    assert got["seg"].dtype == torch.int32
    np.testing.assert_array_equal(n(got["seg"]), np.asarray(want["seg"]))
    # bg → 0, part k → k+1: labels cover [0, K].
    assert 0 <= int(got["seg"].min()) and int(got["seg"].max()) <= 4
    raw = torch.argmax(tm.segmentation(got["logits"]), dim=-1)
    torch.testing.assert_close(got["seg"] == 0, raw == 4)


def test_make_infer_fn_without_background_keeps_labels():
    jm, jp = jax_partnet(use_pallas=True, background=False)
    tm = torch_partnet(jp, background=False)
    x = images(1, 2, 32)
    want = jax_make_infer_fn(jm, jp)(x)
    got = make_infer_fn(tm)(torch.from_numpy(x))          # tensors work as well as numpy
    assert got["logits"].shape[-1] == 4
    np.testing.assert_array_equal(n(got["seg"]), np.asarray(want["seg"]))
    np.testing.assert_allclose(n(got["landmarks"]), np.asarray(want["landmarks"]), atol=1e-5)


def test_infer_image_matches(pair):
    jm, jp, tm = pair
    img = images(2, 1, 32)[0]
    want = jax_infer_image(jm, jp, img)
    got = infer_image(tm, img)
    assert set(got) == set(want)
    for key, atol in TOL.items():
        assert isinstance(got[key], np.ndarray)
        np.testing.assert_allclose(got[key], want[key], atol=atol, err_msg=key)
    np.testing.assert_array_equal(got["seg"], want["seg"])


def test_transfer_matches(pair):
    jm, jp, tm = pair
    a, b = images(3, 2, 32)
    want = jax_transfer(jm, jp, a, b)
    got = transfer(tm, a, b)
    assert isinstance(got, np.ndarray) and got.shape == (32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got - transfer(tm, a, a)).max() > 1e-6     # appearance matters


def test_transfer_batch_is_per_image_transfer(pair):
    _, _, tm = pair
    xs, xa = images(4, 3, 32), images(5, 3, 32)
    batch = transfer_batch(tm, xs, xa)
    assert batch.shape == (3, 32, 32, 3) and torch.isfinite(batch).all()
    for i in range(3):
        np.testing.assert_allclose(n(batch[i]), transfer(tm, xs[i], xa[i]), atol=1e-5)
