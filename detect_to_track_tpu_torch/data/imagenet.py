"""ImageNet VID + DET dataset layer (a copy of the JAX package's
`data/imagenet.py`, which imports no JAX: the same seeds draw the same
pairs, paths, labels and strides).

Behavioral parity with reference detect_to_track/data/imagenet.py, including
the author's documented deviations from the D&T paper (reference
README.md:4-5), which are features here too:

- frame-pair stride tau is sampled from a discrete Laplacian distribution
  (clipped to the snippet) instead of a fixed stride (imagenet.py:72);
- sampling is uniform over snippets first / classes first, instead of
  per-class or per-video caps (imagenet.py:53-65, 189-198);
- DET stills are mixed in with probability p_det, duplicated into a fake
  frame pair with enumerated track ids (imagenet.py:242-265).

Directory layout expected (standard ILSVRC2015):
    DATA_ROOT/
      Data/VID/train/<snippet_id>/000000.JPEG ...
      Annotations/VID/train/<snippet_id>/000000.xml ...
      Data/DET/{train,val}/..., Annotations/DET/{train,val}/...
      ImageSets/VID/train_*.txt, ImageSets/DET/{train_<int>.txt, val.txt}
      devkit/data/map_vid.txt
"""

from __future__ import annotations

import random
from collections import defaultdict
from os import PathLike
from pathlib import Path
from typing import Dict, List, Sequence, Set, Tuple

from PIL import Image

from .pascal import PascalObjectLabel, parse_pascal_xmlfile
from .sampling import partition_items, sample_bernoulli, sample_dlaplace
from .types import (
    DataManager,
    DataManagerWrapper,
    DataSampler,
    ImageInstance,
    ObjectLabel,
    RawImageInstance,
)


class ClassTranslator:
    """wnid -> (int id, readable name), from devkit/data/map_<task>.txt
    (reference imagenet.py:268-318, _PascalTranslator)."""

    def __init__(self, data_root: PathLike, task: str = "VID") -> None:
        task = task.lower()
        if task not in {"vid", "det"}:
            raise NotImplementedError(f"no class map for task {task!r}")
        self.id_to_int: Dict[str, int] = {}
        self.id_to_name: Dict[str, str] = {}
        with open(Path(data_root, "devkit", "data", f"map_{task}.txt")) as f:
            for line in f:
                wnid, cls_int, cls_name = line.split()
                self.id_to_int[wnid] = int(cls_int)
                self.id_to_name[wnid] = cls_name

    def __call__(self, p: PascalObjectLabel) -> ObjectLabel:
        return ObjectLabel(
            class_id=self.id_to_int[p.class_id],
            class_name=self.id_to_name[p.class_id],
            box=p.bbox,
            track_id=p.track_id,
        )


def _load_instance(ri: RawImageInstance, translator: ClassTranslator):
    return ImageInstance(
        im=Image.open(ri.impath),
        labels=tuple(translator(p) for p in parse_pascal_xmlfile(ri.labelpath)),
    )


class VIDPairSource:
    """lazily samples raw frame-pair paths from the VID training snippets
    (reference imagenet.py:25-83, _VIDRawSampler).

    Validates per-snippet frame/label counts at init (the reference's only
    dataset integrity check, imagenet.py:46-51)."""

    def __init__(
        self,
        data_root: PathLike,
        snippet_ids: Sequence[str],
        a: float,
        rng: random.Random = None,
    ) -> None:
        self.frame_root = Path(data_root, "Data", "VID", "train")
        self.label_root = Path(data_root, "Annotations", "VID", "train")
        self.a = a
        self.rng = rng or random.Random()

        self._framecounts: Dict[str, int] = {}
        for sid in snippet_ids:
            n_frames = len(list(Path(self.frame_root, sid).glob("*.JPEG")))
            n_labels = len(list(Path(self.label_root, sid).glob("*.xml")))
            if n_frames != n_labels:
                raise RuntimeError(
                    f"snippet {sid}: {n_frames} frames but {n_labels} labels"
                )
            if n_frames == 0:
                # an empty snippet passes the count check (0 == 0) but
                # would produce a negative frame index mid-training;
                # fail here where the integrity validation lives.
                raise RuntimeError(f"snippet {sid}: no frames found")
            self._framecounts[sid] = n_frames
        self._snippets = list(self._framecounts)

    def sample(self) -> Tuple[RawImageInstance, RawImageInstance]:
        """uniform snippet -> tau ~ dlaplace(a) clipped -> uniform start.
        Sampling the snippet first maximizes diversity without per-snippet
        frame caps (the reference's stated rationale, imagenet.py:58-65)."""
        sid = self.rng.choice(self._snippets)
        n = self._framecounts[sid]
        tau = sample_dlaplace(self.a, self.rng)
        # np.clip(tau, 0, n-1) parity (reference imagenet.py:73): negative
        # dlaplace draws clamp to 0, so ~38% of draws at a=0.5 become
        # identical-frame pairs -- the reference's exact behavior.
        tau = int(min(max(tau, 0), n - 1))
        i0 = self.rng.randrange(0, n - tau)
        return tuple(
            RawImageInstance(
                impath=Path(self.frame_root, sid, f"{idx:06d}.JPEG"),
                labelpath=Path(self.label_root, sid, f"{idx:06d}.xml"),
            )
            for idx in (i0, i0 + tau)
        )


class VIDSampler(DataSampler):
    """nondeterministic VID frame-pair sampler with lazy decode
    (reference imagenet.py:86-116)."""

    def __init__(
        self,
        data_root: PathLike,
        snippet_ids: Sequence[str],
        a: float,
        seed: int = None,
    ) -> None:
        self._seed = seed
        rng = random.Random(seed)
        self._source = VIDPairSource(data_root, snippet_ids, a, rng)
        self._translator = ClassTranslator(data_root, "VID")

    def reseed(self, salt: int) -> None:
        """salt an EXPLICITLY-seeded stream (resume support: a rebuilt
        sampler must not replay the instances already trained on).
        Entropy-seeded samplers (seed=None) are left untouched."""
        if self._seed is not None:
            self._source.rng = random.Random(f"{self._seed}/{salt}")

    def sample(self) -> Tuple[ImageInstance, ImageInstance]:
        return tuple(
            _load_instance(ri, self._translator)
            for ri in self._source.sample()
        )


class VIDManager(DataManager):
    """fixed sample list drawn once at init, then deterministic indexing
    (reference imagenet.py:119-150; a = 0.5 hardcoded there too)."""

    def __init__(
        self,
        data_root: PathLike,
        snippet_ids: Sequence[str],
        n_samples: int,
        seed: int = None,
    ) -> None:
        source = VIDPairSource(data_root, snippet_ids, 0.5, random.Random(seed))
        self._samples = [source.sample() for _ in range(n_samples)]
        self._translator = ClassTranslator(data_root, "VID")

    def __getitem__(self, i: int) -> Tuple[ImageInstance, ImageInstance]:
        return tuple(
            _load_instance(ri, self._translator) for ri in self._samples[i]
        )

    def __len__(self) -> int:
        return len(self._samples)


class DETSampler(DataSampler):
    """uniform-class-first sampler over DET train+val stills; instances
    containing classes outside VID's 30 are dropped, "extra" sets skipped
    (reference imagenet.py:153-222)."""

    def __init__(self, data_root: PathLike, seed: int = None) -> None:
        self._seed = seed
        self.rng = random.Random(seed)
        self._translator = ClassTranslator(data_root, "VID")
        # (reseed below: same contract as VIDSampler.reseed)
        allowed_ids: Set[str] = set(self._translator.id_to_int)
        allowed_ints = set(self._translator.id_to_int.values())

        label_root = Path(data_root, "Annotations", "DET")
        frame_root = Path(data_root, "Data", "DET")
        self._by_class: Dict[str, List[RawImageInstance]] = defaultdict(list)

        # QUIRK (reference-faithful, imagenet.py:167): the DET list files
        # are indexed with the VID class ints (1..30, map_vid.txt), not the
        # DET ints of those wnids (map_det.txt) -- on a real ILSVRC tree
        # this scans the lists of DET classes 1-30 (alphabetical), not the
        # lists of the 30 VID classes. The label-subset filter below still
        # keeps only pure-VID-class images, so training stays correct; the
        # class MIX of DET augmentation just mirrors the reference's.
        lists = [("train", f"train_{i}") for i in sorted(allowed_ints)]
        lists.append(("val", "val"))
        # QUIRK (reference-faithful, imagenet.py:183-188): an image listed
        # in several list files is appended once PER OCCURRENCE to every
        # one of its class buckets, double-weighting it in the class-first
        # sampling -- preserved exactly; only the redundant XML re-parse is
        # cached away (DET init already costs minutes of XML IO).
        parsed: Dict[Tuple[str, str], frozenset] = {}
        n_lists = 0
        for mode, name in lists:
            list_path = Path(data_root, "ImageSets", "DET", f"{name}.txt")
            if not list_path.exists():
                continue
            n_lists += 1
            with open(list_path) as f:
                for line in f:
                    instance_id = line.split()[0]
                    if "extra" in instance_id:
                        continue
                    labelpath = Path(label_root, mode, f"{instance_id}.xml")
                    impath = Path(frame_root, mode, f"{instance_id}.JPEG")
                    key = (mode, instance_id)
                    if key not in parsed:
                        parsed[key] = frozenset(
                            p.class_id for p in parse_pascal_xmlfile(labelpath)
                        )
                    class_ids = parsed[key]
                    if class_ids and class_ids.issubset(allowed_ids):
                        ri = RawImageInstance(impath=impath, labelpath=labelpath)
                        for cid in class_ids:
                            self._by_class[cid].append(ri)
        self._classes = sorted(self._by_class)
        if not self._classes:
            # fail at construction (the reference fails here too -- its
            # open() raises on a missing list); deferring would crash with
            # a bare IndexError at the first DET draw MID-TRAINING on a
            # VID-only tree (the DET portion is a separate download).
            raise FileNotFoundError(
                f"no usable DET lists under {Path(data_root, 'ImageSets', 'DET')} "
                f"({n_lists} list files found); either provide the DET "
                f"portion of the tree or set P_DET=0"
            )

    def reseed(self, salt: int) -> None:
        """salt an EXPLICITLY-seeded stream (resume support; same contract
        as VIDSampler.reseed). Entropy-seeded samplers are untouched."""
        if self._seed is not None:
            self.rng = random.Random(f"{self._seed}/{salt}")

    def sample(self) -> ImageInstance:
        cid = self.rng.choice(self._classes)
        ri = self.rng.choice(self._by_class[cid])
        return _load_instance(ri, self._translator)


class ImagenetSampler(DataSampler):
    """Bernoulli(p_det) mixture of DET stills (duplicated into a fake pair
    with enumerated track ids) and VID pairs (reference imagenet.py:225-265)."""

    def __init__(
        self,
        vid_sampler: DataSampler,
        det_sampler: DataSampler,
        p_det: float,
        seed: int = None,
    ) -> None:
        self._vid = vid_sampler
        self._det = det_sampler
        self.p_det = p_det
        self._seed = seed
        self.rng = random.Random(seed)

    def reseed(self, salt: int) -> None:
        """see VIDSampler.reseed; delegates to both mixture branches
        (each implements its own reseed -- no attribute poking)."""
        if self._seed is not None:
            self.rng = random.Random(f"{self._seed}/{salt}")
        for s in (self._vid, self._det):
            if hasattr(s, "reseed"):
                s.reseed(salt)

    def sample(self) -> Tuple[ImageInstance, ImageInstance]:
        if sample_bernoulli(self.p_det, self.rng):
            inst = self._det.sample()
            inst = ImageInstance(
                im=inst.im,
                labels=tuple(
                    ObjectLabel(
                        class_id=l.class_id,
                        class_name=l.class_name,
                        box=l.box,
                        track_id=tid,  # arbitrary stable ids for the pair
                    )
                    for tid, l in enumerate(inst.labels)
                ),
            )
            return (inst, inst)  # a still pretends to be an adjacent pair
        return self._vid.sample()


def find_vid_trn_snippet_ids(data_root: PathLike) -> Tuple[str, ...]:
    """snippet ids ($BATCH_NAME/$SNIPPET_NAME) from ImageSets/VID train
    lists, with directory existence validation (reference
    imagenet.py:321-343)."""
    imagesets = Path(data_root, "ImageSets", "VID")
    frame_root = Path(data_root, "Data", "VID", "train")
    label_root = Path(data_root, "Annotations", "VID", "train")

    ids = []
    # QUIRK (reference-faithful, imagenet.py:329): the glob is exactly the
    # reference's `train_[0-9]?.txt`, which matches train_10..train_99 but
    # NOT single-digit lists (train_1.txt..train_9.txt) -- on a standard
    # ILSVRC2015 tree the snippets listed only for classes 1-9 are skipped,
    # in both frameworks identically.
    seen = set()
    for list_path in sorted(imagesets.glob("train_[0-9]?.txt")):
        with open(list_path) as f:
            for line in f:
                sid = line.split()[0]
                if sid in seen:
                    # DEVIATION from the reference (imagenet.py:339), which
                    # appends a multi-class snippet once per list file it
                    # appears in: a duplicated id straddling the partition
                    # boundary would land in BOTH the train and val splits
                    # -- train/val leakage that silently invalidates the
                    # val-loss early stopping this framework adds. First
                    # occurrence wins; order is otherwise preserved.
                    continue
                seen.add(sid)
                for root in (frame_root, label_root):
                    if not Path(root, sid).is_dir():
                        raise FileNotFoundError(f"couldn't find {Path(root, sid)}")
                ids.append(sid)
    return tuple(ids)


def _derive(seed, tag: str):
    """distinct per-component seed from one user seed (None stays None --
    entropy). Seeding the mixture, VID and DET samplers with the IDENTICAL
    seed would start (and, via reseed, keep returning) their Mersenne
    streams bit-identical, correlating the Bernoulli branch choice with the
    branch's own instance draws."""
    return None if seed is None else f"{seed}/{tag}"


def setup_vid_datasets(
    data_root: PathLike,
    vid_partition_sizes: Tuple[float, float],
    trn_size: int,
    val_size: int,
    rep_size: int,
    p_det: float,
    a: float,
    seed: int = None,
) -> Tuple[DataManager, DataManager, DataManager]:
    """assemble (train, val, report) managers over VID+DET
    (reference imagenet.py:346-368)."""
    snippet_ids = find_vid_trn_snippet_ids(data_root)
    trn_snips, val_snips = partition_items(snippet_ids, vid_partition_sizes)

    trn_vid = VIDSampler(data_root, trn_snips, a, _derive(seed, "vid"))
    # val/report sets are FIXED draws even when the train stream is entropy-
    # seeded: early stopping compares val losses across epochs and across
    # watchdog exec-restarts, which only means something on a stable set.
    # (Deviation from the reference, which draws from the unseeded global
    # rng at construction; pass an explicit seed to override.)
    fixed = seed if seed is not None else 0
    val_manager = VIDManager(data_root, val_snips, val_size, fixed)
    rep_manager = VIDManager(data_root, trn_snips, rep_size, fixed)

    # P_DET=0 must work on a VID-only tree (the DET portion is a separate
    # download, and DETSampler fails fast at init when it is absent).
    det = DETSampler(data_root, _derive(seed, "det")) if p_det > 0 else None
    trn = ImagenetSampler(trn_vid, det, p_det, _derive(seed, "mix"))
    trn_manager = DataManagerWrapper(trn, trn_size)

    return trn_manager, val_manager, rep_manager


def setup_val_manager(
    data_root: PathLike,
    vid_partition_sizes: Tuple[float, float],
    val_size: int,
    seed: int = None,
) -> DataManager:
    """the val manager ALONE, with the identical deterministic snippet
    partition as setup_vid_datasets. Eval runs need only this: building the
    full training stack would construct DETSampler, whose init parses every
    listed DET annotation XML -- minutes of wasted IO on a real ILSVRC tree."""
    snippet_ids = find_vid_trn_snippet_ids(data_root)
    _, val_snips = partition_items(snippet_ids, vid_partition_sizes)
    return VIDManager(data_root, val_snips, val_size, seed if seed is not None else 0)


def make_mock_dataset(data_root: PathLike, n_samples: int) -> DataManager:
    """small VID-only subset for quick iteration (reference
    imagenet.py:371-376)."""
    return VIDManager(data_root, find_vid_trn_snippet_ids(data_root), n_samples)
