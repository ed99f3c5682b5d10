"""the port's data layer and host helpers against the JAX package's: the
sampling utilities, pascal parsing, the ImageNet VID / DET samplers and
managers over a tiny ILSVRC-layout tree written here (the tree of
tests/test_data.py), and the prediction filters. The same seeds must give
the same pairs, paths, labels and strides, and the same keep-sets."""

import random

import numpy as np
import pytest
from PIL import Image

from detect_to_track_tpu import filtering as jfilt
from detect_to_track_tpu.data import imagenet as jnet
from detect_to_track_tpu.data import pascal as jpascal
from detect_to_track_tpu.data import sampling as jsamp
from detect_to_track_tpu.data import types as jtypes
from detect_to_track_tpu_torch import filtering as tfilt
from detect_to_track_tpu_torch.data import imagenet as tnet
from detect_to_track_tpu_torch.data import pascal as tpascal
from detect_to_track_tpu_torch.data import sampling as tsamp
from detect_to_track_tpu_torch.data import types as ttypes

WNIDS = ["n0000001", "n0000002"]


def _write_xml(path, objs, im_w=200, im_h=100, with_track=True):
    objects = []
    for wnid, (xmin, ymin, xmax, ymax), tid in objs:
        track = f"<trackid>{tid}</trackid>" if with_track else ""
        objects.append(
            f"<object>{track}<name>{wnid}</name><bndbox><xmax>{xmax}</xmax><xmin>{xmin}</xmin>"
            f"<ymax>{ymax}</ymax><ymin>{ymin}</ymin></bndbox></object>"
        )
    path.write_text(f"<annotation><size><width>{im_w}</width><height>{im_h}</height></size>{''.join(objects)}</annotation>")


@pytest.fixture(scope="module")
def ilsvrc(tmp_path_factory):
    """a tiny ILSVRC2015 tree: 5 VID snippets of 3-6 frames with two objects
    each, 3 DET stills (one with a class outside the map), the devkit map."""
    root = tmp_path_factory.mktemp("ILSVRC")
    devkit = root / "devkit" / "data"
    devkit.mkdir(parents=True)
    (devkit / "map_vid.txt").write_text("".join(f"{w} {i + 1} name{i + 1}\n" for i, w in enumerate(WNIDS)))
    (root / "ImageSets" / "VID").mkdir(parents=True)
    lines = []
    for s in range(5):
        sid = f"ILSVRC2015_VID_train_0000/ILSVRC2015_train_{s:08d}"
        lines.append(f"{sid} 1\n")
        fdir = root / "Data" / "VID" / "train" / sid
        ldir = root / "Annotations" / "VID" / "train" / sid
        fdir.mkdir(parents=True)
        ldir.mkdir(parents=True)
        for t in range(3 + s % 4):
            Image.new("RGB", (200, 100), (s * 40, t * 30, 100)).save(fdir / f"{t:06d}.JPEG")
            _write_xml(ldir / f"{t:06d}.xml", [(WNIDS[s % 2], (10 + t, 20, 60 + t, 80), 0),
                                                (WNIDS[(s + 1) % 2], (100, 5 + t, 150, 40 + t), 1)])
    (root / "ImageSets" / "VID" / "train_10.txt").write_text("".join(lines))
    (root / "ImageSets" / "DET").mkdir(parents=True)
    for d, wnid in enumerate(WNIDS + ["n9999999"]):
        iid = f"ILSVRC2014_train_000{d}/img{d}"
        fdir = root / "Data" / "DET" / "train" / f"ILSVRC2014_train_000{d}"
        ldir = root / "Annotations" / "DET" / "train" / f"ILSVRC2014_train_000{d}"
        fdir.mkdir(parents=True, exist_ok=True)
        ldir.mkdir(parents=True, exist_ok=True)
        Image.new("RGB", (200, 100), (200, d * 100, 0)).save(fdir / f"img{d}.JPEG")
        _write_xml(ldir / f"img{d}.xml", [(wnid, (5, 5, 50, 50), None), (WNIDS[0], (60, 10, 90, 70), None)],
                   with_track=False)
        (root / "ImageSets" / "DET" / f"train_{d + 1}.txt").write_text(f"{iid} {d + 1}\n")
    return root


def _summary(inst):
    """an ImageInstance as (pixels, labels): comparable across packages."""
    return np.asarray(inst.im), tuple(tuple(lbl) for lbl in inst.labels)


def _assert_same_instances(got, ref):
    if isinstance(ref, tuple) and not hasattr(ref, "im"):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same_instances(g, r)
        return
    (gim, glbl), (rim, rlbl) = _summary(got), _summary(ref)
    np.testing.assert_array_equal(gim, rim)
    assert glbl == rlbl


@pytest.mark.parametrize("a", [0.3, 0.8, 2.0])
def test_sampling_utilities_match_jax(a):
    """the same random.Random seeds draw the same discrete-Laplace strides
    and Bernoulli draws; partitions and windows are equal."""
    got_rng, ref_rng = random.Random(7), random.Random(7)
    assert [tsamp.sample_dlaplace(a, got_rng) for _ in range(500)] == [jsamp.sample_dlaplace(a, ref_rng) for _ in range(500)]
    assert [tsamp.sample_bernoulli(0.3, got_rng) for _ in range(200)] == [jsamp.sample_bernoulli(0.3, ref_rng) for _ in range(200)]
    items = list(range(23))
    for sizes in ((0.8, 0.2), (1, 1, 1), (0.5, 0.3, 0.2)):
        assert tsamp.partition_items(items, sizes) == jsamp.partition_items(items, sizes)
    assert list(tsamp.sliding_window(items, 3)) == list(jsamp.sliding_window(items, 3))
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="a > 0"):
            tsamp.sample_dlaplace(bad, random.Random(0))


def test_pascal_and_translator_match_jax(ilsvrc):
    path = next((ilsvrc / "Annotations" / "VID" / "train").rglob("*.xml"))
    assert tpascal.parse_pascal_xmlfile(path) == jpascal.parse_pascal_xmlfile(path)
    got, ref = tnet.ClassTranslator(ilsvrc), jnet.ClassTranslator(ilsvrc)
    assert (got.id_to_int, got.id_to_name) == (ref.id_to_int, ref.id_to_name)
    for p in jpascal.parse_pascal_xmlfile(path):
        assert tuple(got(p)) == tuple(ref(p))
    with pytest.raises(NotImplementedError):
        tnet.ClassTranslator(ilsvrc, "pascal")


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_vid_samplers_and_managers_match_jax(ilsvrc, seed):
    """VIDPairSource draws the same paths (so the same strides), VIDSampler
    the same decoded pairs, VIDManager the same fixed list, and reseed
    continues both streams alike."""
    ids = tnet.find_vid_trn_snippet_ids(ilsvrc)
    assert ids == jnet.find_vid_trn_snippet_ids(ilsvrc) and len(ids) == 5
    got = tnet.VIDPairSource(ilsvrc, ids, 0.8, random.Random(seed))
    ref = jnet.VIDPairSource(ilsvrc, ids, 0.8, random.Random(seed))
    pairs = [got.sample() for _ in range(40)]
    assert [tuple(tuple(r) for r in p) for p in pairs] == [tuple(tuple(r) for r in ref.sample()) for _ in range(40)]
    taus = {int(p[1].impath.stem) - int(p[0].impath.stem) for p in pairs}
    assert 0 in taus and len(taus) > 1  # identical-frame pairs and real strides

    got_s, ref_s = tnet.VIDSampler(ilsvrc, ids, 0.8, seed), jnet.VIDSampler(ilsvrc, ids, 0.8, seed)
    for _ in range(6):
        _assert_same_instances(got_s.sample(), ref_s.sample())
    got_s.reseed(3)
    ref_s.reseed(3)
    for _ in range(4):
        _assert_same_instances(got_s.sample(), ref_s.sample())

    got_m, ref_m = tnet.VIDManager(ilsvrc, ids, 7, seed), jnet.VIDManager(ilsvrc, ids, 7, seed)
    assert len(got_m) == len(ref_m) == 7
    assert [tuple(map(tuple, s)) for s in got_m._samples] == [tuple(map(tuple, s)) for s in ref_m._samples]
    _assert_same_instances(got_m[3], ref_m[3])


def test_det_and_mixture_samplers_match_jax(ilsvrc):
    """DETSampler keeps only pure-VID-class stills and draws the same ones;
    ImagenetSampler's Bernoulli mixture gives the same sequence of DET
    fake pairs (enumerated track ids) and VID pairs, before and after a
    reseed."""
    got_det, ref_det = tnet.DETSampler(ilsvrc, seed=2), jnet.DETSampler(ilsvrc, seed=2)
    assert got_det._classes == ref_det._classes
    assert {k: [tuple(r) for r in v] for k, v in got_det._by_class.items()} == {
        k: [tuple(r) for r in v] for k, v in ref_det._by_class.items()
    }
    ids = jnet.find_vid_trn_snippet_ids(ilsvrc)
    got = tnet.ImagenetSampler(tnet.VIDSampler(ilsvrc, ids, 0.8, "v"), got_det, 0.5, seed="m")
    ref = jnet.ImagenetSampler(jnet.VIDSampler(ilsvrc, ids, 0.8, "v"), ref_det, 0.5, seed="m")
    stills = 0
    for n in range(24):
        if n == 12:
            got.reseed(12)
            ref.reseed(12)
        g, r = got.sample(), ref.sample()
        _assert_same_instances(g, r)
        stills += g[0] is g[1]
    assert 0 < stills < 24
    with pytest.raises(FileNotFoundError):
        tnet.DETSampler(ilsvrc / "ImageSets")


@pytest.mark.parametrize("seed", [None, 4])
def test_setup_functions_match_jax(ilsvrc, seed):
    """setup_vid_datasets (the 80/20 snippet partition, fixed val and report
    draws, the DET mixture), setup_val_manager and make_mock_dataset."""
    args = (ilsvrc, (0.8, 0.2), 6, 3, 2, 0.5, 0.8)
    got, ref = tnet.setup_vid_datasets(*args, seed=seed), jnet.setup_vid_datasets(*args, seed=seed)
    assert isinstance(got[0], ttypes.DataManagerWrapper) and len(got[0]) == 6
    for g, r in zip(got[1:], ref[1:]):
        assert [tuple(map(tuple, s)) for s in g._samples] == [tuple(map(tuple, s)) for s in r._samples]
    if seed is not None:  # an explicit seed makes the training stream reproducible
        for n in range(6):
            _assert_same_instances(got[0][n], ref[0][n])
        got[0].reseed(9)
        ref[0].reseed(9)
        _assert_same_instances(got[0][0], ref[0][0])
    val_got = tnet.setup_val_manager(ilsvrc, (0.8, 0.2), 3, seed=seed)
    val_ref = jnet.setup_val_manager(ilsvrc, (0.8, 0.2), 3, seed=seed)
    assert [tuple(map(tuple, s)) for s in val_got._samples] == [tuple(map(tuple, s)) for s in got[1]._samples]
    assert [tuple(map(tuple, s)) for s in val_got._samples] == [tuple(map(tuple, s)) for s in val_ref._samples]
    mock = tnet.make_mock_dataset(ilsvrc, 4)
    assert len(mock) == 4 and len(mock[0]) == 2


def test_types_match_jax():
    """pack_labels and the wrapper's nominal length and reseed pass-through."""
    labels = [ttypes.ObjectLabel(1 + i % 3, f"c{i}", (0.1 * i, 0.2, 0.3, 0.4), None if i % 2 else i) for i in range(5)]
    jlabels = [jtypes.ObjectLabel(*lbl) for lbl in labels]
    for cap in (3, 8):
        for g, r in zip(ttypes.pack_labels(labels, cap), jtypes.pack_labels(jlabels, cap)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)

    class Sampler(ttypes.DataSampler):
        def __init__(self):
            self.salt = None

        def sample(self):
            return self.salt

        def reseed(self, salt):
            self.salt = salt

    w = ttypes.DataManagerWrapper(Sampler(), 5)
    w.reseed(11)
    assert len(w) == 5 and w[0] == 11


def _detections(seed, n=60):
    rng = np.random.RandomState(seed)
    centers = rng.rand(8, 2)
    boxes = np.concatenate([centers[rng.randint(0, 8, n)] + 0.03 * rng.randn(n, 2), 0.1 + 0.2 * rng.rand(n, 2)], 1)
    confs = np.round(rng.rand(n), 2).astype(np.float32)  # rounded: exact ties
    return confs, boxes.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
def test_filters_match_jax(seed):
    """the confidence, top-k and NMS filters and their pipeline: the same
    kept detections in the same order."""
    confs, boxes = _detections(seed)
    pipes = [
        (tfilt.ConfidenceFilter(0.4), jfilt.ConfidenceFilter(0.4)),
        (tfilt.MaxDetFilter(17), jfilt.MaxDetFilter(17)),
        (tfilt.NMSFilter(0.3), jfilt.NMSFilter(0.3)),
        (
            tfilt.PredictionFilterPipeline(tfilt.ConfidenceFilter(0.2), tfilt.NMSFilter(0.5), tfilt.MaxDetFilter(10)),
            jfilt.PredictionFilterPipeline(jfilt.ConfidenceFilter(0.2), jfilt.NMSFilter(0.5), jfilt.MaxDetFilter(10)),
        ),
    ]
    for got_f, ref_f in pipes:
        got, ref = got_f(confs, boxes), ref_f(confs, boxes)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    empty = (np.zeros(0, np.float32), np.zeros((0, 4), np.float32))
    assert len(tfilt.NMSFilter(0.3)(*empty)[0]) == 0
