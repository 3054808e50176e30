"""Port parity for the data layer, JAX package vs port, on the CPU.

``pyramid_flow_tpu_torch/data/`` is the port's own copy of the JAX
package's numpy data layer (the port imports nothing of that package): the
datasets, the bucketeers, the sharded view, the prefetcher and the loader
factories. Both read the same seeded files written here (PNG images, .npy
latents, MJPG videos written with cv2) and must give the same items, shapes,
values, bucket order and rank roles, exactly. The cases mirror JAX's
``tests/test_data_utils.py``. No model; a few seconds.
"""

import json

import numpy as np
import pytest
from PIL import Image

from pyramid_flow_tpu.data import bucket as jbucket
from pyramid_flow_tpu.data import datasets as jdatasets
from pyramid_flow_tpu.data import loaders as jloaders
from pyramid_flow_tpu_torch.data import bucket, datasets, loaders

RATIOS = (1.0, 3 / 5, 5 / 3)
SIZES = ((32, 32), (24, 40), (40, 24))


def _write_anno(path, items):
    path.write_text("\n".join(json.dumps(x) for x in items))
    return str(path)


@pytest.fixture(scope="module")
def image_jsonl(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    items = []
    for i, (w, h) in enumerate([(64, 64), (48, 80), (80, 48), (64, 64),
                                (50, 70), (90, 60)]):
        p = d / f"im{i}.png"
        Image.fromarray(
            rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(p)
        items.append({"image": str(p), "text": f"caption {i}"})
    return _write_anno(d / "anno.jsonl", items)


@pytest.fixture(scope="module")
def latent_jsonl(tmp_path_factory):
    d = tmp_path_factory.mktemp("latents")
    rng = np.random.default_rng(1)
    items = []
    for i, t in enumerate([3, 5, 3, 5, 3, 5]):
        p = d / f"lat{i}.npy"
        np.save(p, rng.standard_normal((t, 8, 8, 16)).astype(np.float32))
        items.append({"latent": str(p), "text": f"vid {i}"})
    return _write_anno(d / "anno.jsonl", items)


@pytest.fixture(scope="module")
def video_jsonl(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(2)
    items = []
    for i, frames in enumerate([7, 12, 9]):
        path = str(d / f"clip{i}.avi")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 24,
                              (64, 48))
        for _ in range(frames):
            out.write(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
        out.release()
        items.append({"video": path})
    return _write_anno(d / "videos.jsonl", items)


def assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_image_text_dataset_matches_jax(image_jsonl):
    kw = dict(ratios=RATIOS, sizes=SIZES)
    port = datasets.ImageTextDataset(image_jsonl, **kw)
    ref = jdatasets.ImageTextDataset(image_jsonl, **kw)
    assert len(port) == len(ref) == 6
    for i in range(6):
        item = port[i]
        assert_items_equal(item, ref[i])
        assert item["image"].shape[:2] == SIZES[item["bucket"]]
        assert item["image"].min() >= -1.0 and item["image"].max() <= 1.0
    assert [port[i]["bucket"] for i in range(3)] == [0, 2, 1]


def test_video_and_image_datasets_match_jax(video_jsonl, image_jsonl):
    """Raw clips for VAE training (fps resample, loop-pad, temporal crop,
    resize and centre crop) and images packed into pseudo-videos."""
    kw = dict(num_frames=9, resolution=(32, 40))
    port = datasets.VideoDataset(video_jsonl, **kw)
    ref = jdatasets.VideoDataset(video_jsonl, **kw)
    assert len(port) == len(ref) == 3
    for i in range(3):
        item = port[i]
        assert_items_equal(item, ref[i])
        assert item["video"].shape == (9, 32, 40, 3)
    kw = dict(max_frames=2, resolution=(24, 24))
    port = datasets.ImageDataset(image_jsonl, **kw)
    ref = jdatasets.ImageDataset(image_jsonl, **kw)
    assert len(port) == len(ref) == 3
    for i in range(3):
        item = port[i]
        assert_items_equal(item, ref[i])
        assert item["video"].shape == (2, 24, 24, 3)


def test_bucketeers_match_jax(image_jsonl, latent_jsonl):
    """The aspect-ratio bucketeer over images and the temporal-length one
    over latents yield the same batches in the same order."""
    kw = dict(ratios=RATIOS, sizes=SIZES)
    port = bucket.Bucketeer(datasets.ImageTextDataset(image_jsonl, **kw), 2,
                            seed=3)
    ref = jbucket.Bucketeer(jdatasets.ImageTextDataset(image_jsonl, **kw), 2,
                            seed=3)
    for _ in range(5):
        got, want = next(port), next(ref)
        assert len(got) == len(want) == 2
        assert got[0]["bucket"] == got[1]["bucket"]
        for a, b in zip(got, want):
            assert_items_equal(a, b)
    port = bucket.TemporalLengthBucketeer(
        datasets.LengthGroupedVideoTextDataset(latent_jsonl, max_frames=4,
                                               load_text_fea=False), 2)
    ref = jbucket.TemporalLengthBucketeer(
        jdatasets.LengthGroupedVideoTextDataset(latent_jsonl, max_frames=4,
                                                load_text_fea=False), 2)
    lengths = set()
    for _ in range(6):
        got, want = next(port), next(ref)
        assert got.keys() == want.keys() == {"latents", "identifier", "text"}
        np.testing.assert_array_equal(got["latents"], want["latents"])
        assert got["text"] == want["text"]
        assert got["latents"].shape[2:] == (8, 8, 16)
        lengths.add(got["latents"].shape[1])
    assert lengths == {3, 4}


def test_sharded_dataset_and_prefetcher_match_jax(latent_jsonl):
    port_ds = datasets.LengthGroupedVideoTextDataset(latent_jsonl,
                                                     load_text_fea=False)
    ref_ds = jdatasets.LengthGroupedVideoTextDataset(latent_jsonl,
                                                     load_text_fea=False)
    for rank, world, sync in ((0, 2, 1), (1, 2, 1), (0, 4, 2), (1, 4, 2),
                              (3, 4, 2), (2, 4, 1)):
        port = loaders.ShardedDataset(port_ds, rank, world, sync)
        ref = jloaders.ShardedDataset(ref_ds, rank, world, sync)
        assert len(port) == len(ref)
        for i in range(len(port) + 1):  # one past the end wraps
            assert_items_equal(port[i], ref[i])
    assert len(loaders.ShardedDataset(port_ds, 0, 2)) == 3
    # ranks of one sync group read the same items
    g0 = loaders.ShardedDataset(port_ds, 0, 4, 2)
    g1 = loaders.ShardedDataset(port_ds, 1, 4, 2)
    np.testing.assert_array_equal(g0[0]["latent"], g1[0]["latent"])

    port, ref = (loaders.Prefetcher(iter(range(5)), depth=2),
                 jloaders.Prefetcher(iter(range(5)), depth=2))
    assert [next(port) for _ in range(5)] == [next(ref) for _ in range(5)] \
        == list(range(5))
    port.close()
    ref.close()


def test_loader_factories_match_jax(image_jsonl, latent_jsonl, video_jsonl):
    """The image-text, length-grouped and mixed loaders per rank: the same
    batches, and the same video/image role of each rank."""
    kw = dict(ratios=RATIOS, sizes=SIZES)
    for rank in (0, 1):
        port = loaders.create_image_text_dataloader(
            datasets.ImageTextDataset(image_jsonl, **kw), 2, rank, 2)
        ref = jloaders.create_image_text_dataloader(
            jdatasets.ImageTextDataset(image_jsonl, **kw), 2, rank, 2)
        for _ in range(2):
            for a, b in zip(next(port), next(ref)):
                assert_items_equal(a, b)
        port.close()
        ref.close()

    port = loaders.create_length_grouped_video_text_dataloader(
        datasets.LengthGroupedVideoTextDataset(latent_jsonl,
                                               load_text_fea=False), 2)
    ref = jloaders.create_length_grouped_video_text_dataloader(
        jdatasets.LengthGroupedVideoTextDataset(latent_jsonl,
                                                load_text_fea=False), 2)
    got, want = next(port), next(ref)
    assert got["latents"].shape[0] == 2
    np.testing.assert_array_equal(got["latents"], want["latents"])
    port.close()
    ref.close()

    roles = []
    for rank in range(4):
        port, role = loaders.create_mixed_dataloaders(
            datasets.VideoDataset(video_jsonl, 5, (16, 16)),
            datasets.ImageDataset(image_jsonl, 5, (16, 16)), 1, rank, 4,
            image_mix_ratio=0.25)
        ref, jrole = jloaders.create_mixed_dataloaders(
            jdatasets.VideoDataset(video_jsonl, 5, (16, 16)),
            jdatasets.ImageDataset(image_jsonl, 5, (16, 16)), 1, rank, 4,
            image_mix_ratio=0.25)
        roles.append(role)
        assert role == jrole
        got, want = next(port), next(ref)
        assert got["identifier"] == want["identifier"] == [role]
        assert got["video"].shape == (1, 5, 16, 16, 3)
        np.testing.assert_array_equal(got["video"], want["video"])
        port.close()
        ref.close()
    assert roles == ["video", "video", "video", "image"]
