"""Port parity: partseg_tpu_torch.data against the JAX package's data
pipelines, on the CPU.

The datasets are built from tiny fixture trees in tmp_path (no real
dataset is on this machine), as tests/test_datasets.py builds them, and
each example of the port's dataset is compared with the JAX dataset's,
array for array: both decode with cv2 and crop with the same numpy, so
they agree exactly. The loaders are held to the JAX package's native
loader order (partseg_tpu/data/native.py), index for index: the port has
no grain, and follows that order for every backend.
"""

import pathlib

import numpy as np
import pytest
import torch

import partseg_tpu.data  # noqa: F401  (registers the JAX datasets)
from partseg_tpu.data.base import ImageListDataset as JImageListDataset
from partseg_tpu.data.check import check_data as jax_check_data
from partseg_tpu.data.loader import make_loader as jax_make_loader
from partseg_tpu.data.registry import build_dataset as jax_build_dataset
from partseg_tpu.data.synthetic import SyntheticBlobs as JSyntheticBlobs
from partseg_tpu_torch.data import SyntheticBlobs, build_dataset, make_loader, prefetch
from partseg_tpu_torch.data.base import ImageListDataset
from partseg_tpu_torch.data.check import check_data
from partseg_tpu_torch.data.loader import batch_indices

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)


def _write_img(path: pathlib.Path, h=40, w=30, seed=0):
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cv2.imwrite(str(path), rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))


def _celeba(root: pathlib.Path):
    root = root / "celeba"
    names = [f"{i:06d}.jpg" for i in range(1, 7)]
    for i, n in enumerate(names):
        _write_img(root / "img_align_celeba" / n, seed=i)
    lm_lines = ["6", "lefteye_x lefteye_y ..."]
    lm_lines += [n + " 10 12 20 12 15 18 12 25 18 25" for n in names]
    (root / "list_landmarks_align_celeba.txt").write_text("\n".join(lm_lines))
    (root / "mafl_training.txt").write_text("\n".join(names[:4]))
    (root / "mafl_testing.txt").write_text("\n".join(names[4:]))
    return {"celeba": [("train", 4), ("test", 2), ("unsup", 4)]}, dict(size=32)


def _cub(root: pathlib.Path):
    root = root / "CUB_200_2011"
    (root / "parts").mkdir(parents=True)
    ids = ["1", "2", "3"]
    rel = {i: f"001.Bird/img_{i}.jpg" for i in ids}
    for i in ids:
        _write_img(root / "images" / rel[i], h=50, w=60, seed=int(i))
    (root / "images.txt").write_text("\n".join(f"{i} {rel[i]}" for i in ids))
    (root / "train_test_split.txt").write_text("1 1\n2 1\n3 0")
    (root / "bounding_boxes.txt").write_text("1 5 5 40 30\n2 10 10 30 30\n3 0 0 50 40")
    locs = [f"{i} {p} 20 20 {1 if p <= 3 else 0}" for i in ids for p in range(1, 16)]
    (root / "parts" / "part_locs.txt").write_text("\n".join(locs))
    return {"cub": [("train", 2), ("test", 1)]}, dict(size=24)


def _deepfashion(root: pathlib.Path):
    root = root / "deepfashion"
    names = [f"img/Sub/{i:03d}.jpg" for i in range(4)]
    for i, n in enumerate(names):
        _write_img(root / "Img" / n, seed=i)
    (root / "Eval").mkdir(parents=True)
    lines = ["4", "image_name evaluation_status"]
    lines += [f"{n} {s}" for n, s in zip(names, ["train", "train", "gallery", "query"])]
    (root / "Eval" / "list_eval_partition.txt").write_text("\n".join(lines))
    (root / "Anno").mkdir(parents=True)
    anno = ["4", "image_name clothes_type variation_type landmarks"]
    anno += [n + " 1 1 " + " ".join(["0 10 15"] * 4) for n in names]
    (root / "Anno" / "list_landmarks_inshop.txt").write_text("\n".join(anno))
    return {"deepfashion": [("train", 2), ("test", 1)]}, dict(size=16)


def _penn_action(root: pathlib.Path):
    root = root / "penn_action"
    for seq, train in [("0001", 1), ("0002", 0)]:
        for t in range(1, 4):
            _write_img(root / "frames" / seq / f"{t:06d}.jpg", seed=t)
        (root / "labels").mkdir(parents=True, exist_ok=True)
        np.savez(root / "labels" / f"{seq}.npz", x=np.full((3, 13), 10.0),
                 y=np.full((3, 13), 12.0), visibility=np.ones((3, 13), bool),
                 train=np.array([train]))
    return {"penn_action": [("train", 3), ("test", 3)]}, dict(size=16, stride=1)


def _human36m(root: pathlib.Path):
    root = root / "human36m" / "frames"
    for subj in ["S1", "S9"]:
        for t in range(1, 4):
            _write_img(root / subj / "Walking" / f"{t:06d}.jpg", seed=t)
    return {"human36m": [("train", 3), ("test", 3)]}, dict(size=16, stride=1)


FIXTURES = {"celeba": _celeba, "cub": _cub, "deepfashion": _deepfashion,
            "penn_action": _penn_action, "human36m": _human36m}


def _same_examples(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"example {i} {k}")


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_fixture_dataset_matches_jax(fixture, tmp_path, monkeypatch):
    """Each dataset's splits, example for example, against the JAX
    package's on the same fixture tree (tests/test_datasets.py's)."""
    splits, kwargs = FIXTURES[fixture](tmp_path)
    monkeypatch.setenv("PARTSEG_DATA", str(tmp_path))
    (name, cases), = splits.items()
    for split, n in cases:
        got = build_dataset(name, split=split, **kwargs)
        want = jax_build_dataset(name, split=split, **kwargs)
        assert len(got) == n
        _same_examples(got, want)
        assert got[0]["image"].shape == (kwargs["size"], kwargs["size"], 3)
    if name == "celeba":   # the wild variant reads another image dir: missing here
        with pytest.raises(FileNotFoundError):
            build_dataset("celeba_wild", split="train", size=16)


def test_missing_data_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PARTSEG_DATA", str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError):
        build_dataset("celeba", split="train", size=16)[0]
    for name in ("human36m", "penn_action"):
        with pytest.raises(FileNotFoundError):
            build_dataset(name, split="train", size=16)
    with pytest.raises(KeyError, match="unknown dataset"):
        build_dataset("imagenet")


def test_check_data_pass_and_fail(tmp_path, monkeypatch, capsys):
    """The pre-flight check passes on a valid tree and fails, naming the
    split, on an empty mount; the same verdicts as the JAX package's."""
    _celeba(tmp_path)
    monkeypatch.setenv("PARTSEG_DATA", str(tmp_path))
    assert check_data("celeba", {"size": 32}) is True
    out = capsys.readouterr().out
    assert "PASS unsup" in out and "VGG19 weights: random-torch" in out
    assert jax_check_data("celeba", {"size": 32}) is True
    capsys.readouterr()
    monkeypatch.setenv("PARTSEG_DATA", str(tmp_path / "empty"))
    assert check_data("celeba", {"size": 32}) is False
    assert "FAIL train" in capsys.readouterr().out
    assert jax_check_data("celeba", {"size": 32}) is False


def test_synthetic_matches_jax_and_its_masks():
    """The synthetic blobs are the JAX package's, bit for bit (masks too),
    and each blob centre pixel is labelled with its own part."""
    got = SyntheticBlobs(size=32, n_blobs=3, n_examples=4, with_masks=True)
    _same_examples(got, JSyntheticBlobs(size=32, n_blobs=3, n_examples=4, with_masks=True))
    _same_examples(build_dataset("synthetic", split="val", size=16, n_examples=3),
                   jax_build_dataset("synthetic", split="val", size=16, n_examples=3))
    ex = got[0]
    m = ex["mask"]
    assert m.shape == (32, 32) and m.dtype == np.int32
    assert m.min() == 0 and 1 <= m.max() <= 3
    for i, (y, x) in enumerate(ex["landmarks"]):
        iy, ix = int((y + 1) / 2 * 32), int((x + 1) / 2 * 32)
        if 0 <= iy < 32 and 0 <= ix < 32:
            assert m[iy, ix] == i + 1, (i, m[iy, ix])


# -- loaders ------------------------------------------------------------------


@pytest.fixture(scope="module")
def color_images(tmp_path_factory):
    """7 constant-colour PNGs: a batch's rounded means identify the
    examples it holds, whatever the decode path (tests/test_native_loader.py)."""
    tmp = tmp_path_factory.mktemp("colors")
    for i in range(7):
        cv2.imwrite(str(tmp / f"{i}.png"), np.full((20, 20, 3), i * 30, np.uint8))
    return [tmp / f"{i}.png" for i in range(7)]


def _batch_ids(img_batch):
    x = np.asarray(img_batch, np.float32)
    if x.max() <= 1.0:
        x = x * 255.0
    return [int(round(v / 30.0)) for v in x.mean(axis=(1, 2, 3))]


def _ids(loader, n):
    return [_batch_ids(b["image"]) for b, _ in zip(loader, range(n))]


@pytest.mark.parametrize("seed,shuffle,start,pidx,pcnt", [
    (0, False, 0, 0, 1),       # 7 examples in batches of 3: the remainder carries
    (9, True, 0, 0, 1),        # shuffled, one permutation per epoch
    (9, True, 5, 0, 1),        # a seek mid-epoch, two remainders carried
    (4, True, 3, 1, 2),        # the second of two processes' shards, seeked
])
def test_loader_stream_matches_jax_native(color_images, seed, shuffle, start, pidx, pcnt):
    """The port's make_loader, with the native pool and with the indexable
    path, against the JAX package's make_loader(backend="native"), batch
    for batch; a seek to start_batch gives the tail of the unseeked stream."""
    jds = JImageListDataset(paths=color_images, size=16)
    ds = ImageListDataset(paths=color_images, size=16)
    kw = dict(shuffle=shuffle, seed=seed, process_index=pidx, process_count=pcnt)
    want = _ids(jax_make_loader(jds, 3, backend="native", num_workers=1, start_batch=start,
                                **kw), 6)
    assert _ids(make_loader(ds, 3, backend="native", num_workers=1, start_batch=start, **kw),
                6) == want
    assert _ids(make_loader(ds, 3, backend="grain", num_workers=2, start_batch=start, **kw),
                6) == want
    order = [list(map(int, s)) for s, _ in zip(
        batch_indices(7, 3, start_batch=start, **kw), range(6))]
    assert order == want
    if start:
        unseeked = _ids(make_loader(ds, 3, backend="grain", **kw), start + 6)
        assert unseeked[start:] == want


def test_loader_shards_cover_the_index_space_once():
    ds = SyntheticBlobs(size=8, n_blobs=1, n_examples=24)
    seen = np.concatenate([b["image"] for p in range(3) for b in make_loader(
        ds, 4, shuffle=False, num_epochs=1, process_index=p, process_count=3)])
    assert seen.shape[0] == 24
    assert len(np.unique(seen.reshape(24, -1).round(5), axis=0)) == 24


def test_prefetch_preserves_stream():
    ds = SyntheticBlobs(size=8, n_blobs=2, n_examples=16)
    plain = list(make_loader(ds, 4, shuffle=False, num_epochs=1))
    fetched = list(prefetch(make_loader(ds, 4, shuffle=False, num_epochs=1)))
    assert len(plain) == len(fetched) == 4
    for a, b in zip(plain, fetched):
        np.testing.assert_array_equal(a["image"], b["image"])
    seeded = list(prefetch(make_loader(ds, 4, seed=3, num_epochs=2, num_workers=3)))
    assert len(seeded) == 8
    for a, b in zip(seeded, make_loader(ds, 4, seed=3, num_epochs=2)):
        np.testing.assert_array_equal(a["image"], b["image"])
