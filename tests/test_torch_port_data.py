"""The port's data plane against the JAX package's, on the same fixtures.

- The fixture writers (``data/synthetic.py``) write the same files as the
  JAX package's for a seed: JPEG bytes, JSON, h5 datasets.
- ``CocoLayoutDataset[i]`` and ``VgLayoutDataset[i]`` equal the JAX items
  exactly, mirrored items included (images CHW in the port, HWC in JAX),
  with the native decoder and with PIL; so do ``valid_object_counts``.
- ``HostDataLoader`` yields the same batches for a seed over two epochs,
  and the same disjoint shards for 2 processes.
- The port's native binding (built into ``build/native``, never into
  ``native/``) decodes exactly as the JAX binding does, and both are within
  ``tests/test_native.py``'s bars of PIL; ``shuffle_indices`` is equal.
- ``cli/preprocess_vg.py`` writes the same vocabulary and h5 datasets.
- ``SyntheticLayoutDataset``, ``MetricWriter`` (JSONL lines, PNG grid) and
  the CPU prefetch; the fg/bg split of the Ours-ED family against JAX's.
"""

import json
import os

import numpy as np
import pytest
import torch

from layout2img_tpu.cli.preprocess_vg import main as jax_preprocess_vg
from layout2img_tpu.data import coco as jax_coco
from layout2img_tpu.data import native as jax_native
from layout2img_tpu.data import synthetic as jax_synthetic
from layout2img_tpu.data import vg as jax_vg
from layout2img_tpu.utils.logging import MetricWriter as JaxMetricWriter
from layout2img_tpu_torch.cli.preprocess_vg import main as preprocess_vg
from layout2img_tpu_torch.data import coco, native, synthetic, vg
from layout2img_tpu_torch.data.prefetch import device_prefetch
from layout2img_tpu_torch.utils.logging import MetricWriter
from test_torch_port_step_knobs import _few_threads  # noqa: F401  (autouse)

W, H, N_IMAGES, SIZE = 96, 80, 6, 32


@pytest.fixture(scope="module")
def coco_fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    _, inst = synthetic.write_synthetic_coco(root, N_IMAGES, width=W, height=H, seed=3)
    return root, inst, synthetic.write_synthetic_stuff(root, inst, seed=4)


@pytest.fixture(scope="module")
def vg_fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vg"))
    return synthetic.write_synthetic_vg(root, N_IMAGES, width=W, height=H, objects_per_image=7,
                                        relationships_per_image=3, seed=5, num_classes=12)


def _same_files(a: str, b: str, names) -> None:
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _same_h5(a: str, b: str) -> None:
    import h5py

    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert set(fa) == set(fb)
        for k in fa:
            assert np.array_equal(fa[k][()], fb[k][()]), k
            assert fa[k].dtype == fb[k].dtype, k


def test_coco_fixture_writer_matches_jax(tmp_path, coco_fixture):
    root, inst, _ = coco_fixture
    jax_root, jax_inst = jax_synthetic.write_synthetic_coco(str(tmp_path), N_IMAGES, width=W,
                                                            height=H, seed=3)
    names = [f"{i:06d}.jpg" for i in range(N_IMAGES)] + ["instances.json"]
    _same_files(root, jax_root, names)


def test_vg_fixture_writer_matches_jax(tmp_path, vg_fixture):
    vocab, h5, root = vg_fixture
    # the JAX writer has a fixed 16-name vocabulary: compare at the port's default
    port = synthetic.write_synthetic_vg(str(tmp_path / "p"), 3, width=W, height=H, seed=5)
    want = jax_synthetic.write_synthetic_vg(str(tmp_path / "j"), 3, width=W, height=H, seed=5)
    _same_files(port[2], want[2], ["vocab.json"] + [f"images/{i:06d}.jpg" for i in range(3)])
    _same_h5(port[1], want[1])
    with open(vocab) as f:
        assert len(json.load(f)["object_idx_to_name"]) == 12


def test_stuff_fixture_keeps_every_image_in_range(coco_fixture):
    root, inst, stuff = coco_fixture
    ds = coco.CocoLayoutDataset(root, inst, stuff, image_size=SIZE)
    counts = ds.valid_object_counts()
    assert len(ds) == N_IMAGES and counts.min() >= 6 and counts.max() <= 8
    assert any(int(lab) >= 92 for i in range(len(ds)) for lab in ds[i]["labels"])


def _same_item(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"images", "labels", "boxes"}
    assert got["images"].shape == (3, SIZE, SIZE) and got["images"].dtype == np.float32
    assert np.array_equal(got["images"], want["images"].transpose(2, 0, 1))
    for k in ("labels", "boxes"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("use_native", [True, False])
def test_coco_items_match_jax(coco_fixture, use_native):
    root, inst, stuff = coco_fixture
    kw = dict(image_size=SIZE, left_right_flip=True, use_native=use_native)
    port = coco.CocoLayoutDataset(root, inst, stuff, **kw)
    want = jax_coco.CocoLayoutDataset(root, inst, stuff, **kw)
    assert len(port) == len(want) == 2 * N_IMAGES and port.vocab_size == want.vocab_size
    assert np.array_equal(port.valid_object_counts(), want.valid_object_counts())
    for i in range(len(port)):
        _same_item(port[i], want[i])
    # the mirrored copy: x0 -> 1 - (x0 + w), the image flipped left to right
    a, b = port[0], port[N_IMAGES]
    valid = a["labels"] != 0
    np.testing.assert_allclose(b["boxes"][valid, 0], 1 - a["boxes"][valid, 0] - a["boxes"][valid, 2],
                               atol=1e-6)
    capped = coco.CocoLayoutDataset(root, inst, stuff, max_samples=4, **kw)
    assert len(capped) == 4


@pytest.mark.parametrize("use_native", [True, False])
def test_vg_items_match_jax(vg_fixture, use_native):
    kw = dict(image_size=SIZE, max_objects=5, left_right_flip=True, use_native=use_native, seed=2)
    port, want = vg.VgLayoutDataset(*vg_fixture, **kw), jax_vg.VgLayoutDataset(*vg_fixture, **kw)
    assert len(port) == len(want) == 2 * N_IMAGES and port.num_classes == want.num_classes == 12
    assert np.array_equal(port.valid_object_counts(), want.valid_object_counts())
    for i in range(len(port)):
        _same_item(port[i], want[i])
    item = port[0]
    k = int((item["labels"] != 0).sum())
    assert item["labels"].shape == (6,) and item["labels"][k] == 0
    np.testing.assert_array_equal(item["boxes"][k], [0, 0, 1, 1])


def test_host_loader_batches_match_jax(coco_fixture):
    root, inst, stuff = coco_fixture
    ds = coco.CocoLayoutDataset(root, inst, stuff, image_size=SIZE, left_right_flip=True)
    jds = jax_coco.CocoLayoutDataset(root, inst, stuff, image_size=SIZE, left_right_flip=True)
    port = coco.HostDataLoader(ds, 5, seed=7, num_threads=3, prefetch=2)
    want = jax_coco.HostDataLoader(jds, 5, seed=7, num_threads=3, prefetch=2)
    assert len(port) == len(want) == 2
    firsts = []
    for _ in range(2):  # two epochs: the permutation moves with the epoch
        got = list(port)
        for g, w in zip(got, want, strict=True):
            assert np.array_equal(g["images"], w["images"].transpose(0, 3, 1, 2))
            assert np.array_equal(g["labels"], w["labels"]) and np.array_equal(g["boxes"], w["boxes"])
        firsts.append(got[0]["labels"])
    assert not np.array_equal(*firsts)


def test_host_loader_shards_match_jax(coco_fixture):
    root, inst, stuff = coco_fixture
    ds = coco.CocoLayoutDataset(root, inst, stuff, image_size=8, left_right_flip=True,
                                use_native=False)
    jds = jax_coco.CocoLayoutDataset(root, inst, stuff, image_size=8, left_right_flip=True,
                                     use_native=False)
    seen = []
    for pid in range(2):
        port = list(coco.HostDataLoader(ds, 2, seed=1, process_id=pid, process_count=2))
        want = list(jax_coco.HostDataLoader(jds, 2, seed=1, process_id=pid, process_count=2))
        assert len(port) == len(want) == 3
        for g, w in zip(port, want):
            assert np.array_equal(g["images"], w["images"].transpose(0, 3, 1, 2))
        seen.append({(b["images"][i].tobytes(), b["boxes"][i].tobytes())
                     for b in port for i in range(2)})
    assert len(seen[0]) == len(seen[1]) == 6 and not seen[0] & seen[1]


def test_native_decode_matches_jax_binding_and_pil(coco_fixture):
    import PIL.Image

    assert native.native_available(), native.build_error()
    assert jax_native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    root = coco_fixture[0]
    files = [os.path.join(root, f"{i:06d}.jpg") for i in range(N_IMAGES)]
    flips = [i % 2 == 1 for i in range(N_IMAGES)]
    batch = native.load_batch(files, 48, flips, threads=3)
    assert np.array_equal(batch, jax_native.load_batch(files, 48, flips, threads=3))
    for i, f in enumerate(files):
        got = native.load_image(f, 48, flips[i])
        assert np.array_equal(got, jax_native.load_image(f, 48, flips[i]))
        assert np.array_equal(got, batch[i])
    with PIL.Image.open(files[0]) as im:
        want = np.asarray(im.convert("RGB").resize((48, 48), PIL.Image.BILINEAR), np.float32)
    want = (want / 255.0 - 0.5) * 2
    diff = np.abs(batch[0] - want)
    assert diff.mean() < 0.02 and diff.max() < 0.15  # tests/test_native.py's bars
    with pytest.raises(IOError):
        native.load_image(os.path.join(root, "instances.json"), 8)


def test_shuffle_indices_match_jax():
    for seed, n in ((0, 1), (3, 100), (11, 4097)):
        got = native.shuffle_indices(seed, n)
        assert np.array_equal(got, jax_native.shuffle_indices(seed, n))
        assert np.array_equal(np.sort(got), np.arange(n))


def _raw_vg(root, rng):
    import PIL.Image

    img_dir = os.path.join(root, "VG_100K")
    os.makedirs(img_dir)
    images, objects, rels = [], [], []
    oid = 0
    for i in range(10):
        images.append({"image_id": i, "width": 300, "height": 250 if i != 3 else 150,
                       "url": f"http://x/VG_100K/{i}.jpg"})
        PIL.Image.fromarray((rng.random((25, 30, 3)) * 255).astype(np.uint8)).save(
            os.path.join(img_dir, f"{i}.jpg"))
        objs = [{"object_id": oid + j, "names": [("Dog", "tree", "cat", "sky")[(i + j) % 4]],
                 "x": 10 + j * 5, "y": 10, "w": 60 if j != 2 else 20, "h": 70} for j in range(5)]
        oid += 5
        objects.append({"image_id": i, "objects": objs})
        rels.append({"image_id": i, "relationships": [
            {"predicate": ("next to", "on")[i % 2], "subject": {"object_id": objs[0]["object_id"]},
             "object": {"object_id": objs[1]["object_id"]}}]})
    for name, data in (("image_data.json", images), ("objects.json", objects),
                       ("relationships.json", rels)):
        with open(os.path.join(root, name), "w") as f:
            json.dump(data, f)
    with open(os.path.join(root, "object_alias.txt"), "w") as f:
        f.write("dog,doggy\n")


def test_preprocess_vg_matches_jax(tmp_path, rng):
    _raw_vg(str(tmp_path), rng)
    args = ["--vg_dir", str(tmp_path), "--min_object_instances", "2",
            "--min_relationship_instances", "1", "--min_objects_per_image", "2",
            "--max_objects_per_image", "5", "--val_fraction", "0.2", "--test_fraction", "0.2"]
    preprocess_vg(args + ["--output_dir", str(tmp_path / "port")])
    jax_preprocess_vg(args + ["--output_dir", str(tmp_path / "jax")])
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"), ["vocab.json"])
    for split in ("train", "val", "test"):
        _same_h5(str(tmp_path / "port" / f"{split}.h5"), str(tmp_path / "jax" / f"{split}.h5"))
    ds = vg.VgLayoutDataset(str(tmp_path / "port" / "vocab.json"),
                            str(tmp_path / "port" / "train.h5"), str(tmp_path), image_size=16,
                            max_objects=5)
    assert len(ds) >= 1 and ds[0]["images"].shape == (3, 16, 16)


def test_synthetic_layout_dataset_matches_jax():
    port = synthetic.SyntheticLayoutDataset(2, 16, 8, 20, seed=4, steps=3)
    want = jax_synthetic.SyntheticLayoutDataset(2, 16, 8, 20, seed=4, steps=3)
    got = list(port)
    assert len(got) == 3
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g["images"], w["images"].transpose(0, 3, 1, 2))
        assert np.array_equal(g["labels"], w["labels"]) and np.array_equal(g["boxes"], w["boxes"])
    assert np.array_equal(port.valid_object_counts(), want.valid_object_counts())


def test_metric_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (5, 3, 8, 6)).astype(np.float32)
    for writer, imgs in ((MetricWriter(str(tmp_path / "port"), tensorboard=True), images),
                         (JaxMetricWriter(str(tmp_path / "jax")), images.transpose(0, 2, 3, 1))):
        writer.write(3, {"d_loss": np.float32(1.5), "g_loss": torch.tensor(-2.0)})
        writer.write_images(3, "fake", imgs)
        writer.close()
    lines = [json.loads(ln) for ln in open(tmp_path / "port" / "metrics.jsonl")]
    assert len(lines) == 1 and lines[0]["step"] == 3 and lines[0]["g_loss"] == -2.0
    assert set(lines[0]) == {"step", "time", "d_loss", "g_loss"}
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"), ["images/fake_00000003.png"])
    MetricWriter(str(tmp_path / "port")).write_images(4, "t", torch.from_numpy(images))
    assert os.path.exists(tmp_path / "port" / "images" / "t_00000004.png")
    assert os.listdir(tmp_path / "port" / "tb")


def test_cpu_prefetch_converts_and_raises():
    rng = np.random.default_rng(1)
    host = [{"images": rng.random((2, 3, 4, 4), dtype=np.float32),
             "labels": rng.integers(0, 9, (2, 8)).astype(np.int32)} for _ in range(5)]
    got = list(device_prefetch(iter(host), "cpu", size=2))
    assert len(got) == 5
    for g, h in zip(got, host):
        assert all(isinstance(v, torch.Tensor) and np.array_equal(v.numpy(), h[k])
                   for k, v in g.items())

    def broken():
        yield host[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(device_prefetch(broken(), "cpu"))
    stream = device_prefetch(iter(host * 10), "cpu", size=1)
    next(stream)
    stream.close()  # the worker stops when the consumer goes


def test_fg_bg_split_names_the_roadmap(coco_fixture):
    """The Ours-ED split is ported (ROADMAP §1 item 5): items of
    ``fg_bg_split=True`` carry the two streams, equal to JAX's."""
    root, inst, stuff = coco_fixture
    ds = coco.CocoLayoutDataset(root, inst, stuff, fg_bg_split=True)
    ref = jax_coco.CocoLayoutDataset(root, inst, stuff, fg_bg_split=True)
    for k in ("labels_fg", "boxes_fg", "labels_bg", "boxes_bg"):
        assert np.array_equal(ds[0][k], ref[0][k]), k
    got = coco.split_fg_bg(np.zeros(8, np.int32), np.zeros((8, 4), np.float32))
    assert not got["labels_fg"].any() and not got["labels_bg"].any()
    assert np.array_equal(got["boxes_bg"], np.tile(np.float32(coco.PAD_BOX), (8, 1)))