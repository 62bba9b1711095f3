"""Real-format dataset parsers — the file-reading half of the reference's
dataset zoo; a copy of ``paddle_tpu/data/parsers.py``.

The reference's datasets download real archives and parse real bytes
(python/paddle/v2/dataset/common.py:33-64 download+md5 cache; mnist.py:42-75
idx parsing; cifar.py pickled tar members; conll05.py column corpus;
wmt14.py tokenized parallel text). This package fetches nothing, so the
*download* half is stubbed loudly (see :func:`download`) — but the parsers
are real and tested against checked-in fixtures (tests/fixtures/), so a
deployment with data on disk feeds real bytes through the same reader API
the synthetic generators expose.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import pickle
import struct
import tarfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- common ----
# dataset/common.py analog: cache layout + md5 discipline; download is a
# loud offline stub (file:// and existing-file paths still work).

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def md5file(path: str) -> str:
    """dataset/common.py md5file: streaming md5 of a file."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module_name: str, md5sum: Optional[str] = None) -> str:
    """Cache-or-fail (dataset/common.py:33-64 role). A cached file with a
    matching md5 is returned; otherwise this raises — nothing is fetched,
    and silently truncated datasets are worse than loud ones. The cache is
    JAX's (``PADDLE_TPU_DATA_HOME``), so both packages find the same
    files."""
    cache_dir = os.path.join(DATA_HOME, module_name)
    os.makedirs(cache_dir, exist_ok=True)
    filename = os.path.join(cache_dir, url.split("/")[-1])
    if url.startswith("file://"):
        filename = url[len("file://"):]
    if os.path.exists(filename):
        if md5sum is not None and md5file(filename) != md5sum:
            raise IOError(f"{filename}: md5 mismatch (corrupt cache); "
                          "delete it and re-provision")
        return filename
    raise IOError(
        f"{url} is not cached at {filename} and this package fetches "
        "nothing (no network egress); place the file there (or use a "
        "file:// url) — "
        "the parser side is fully supported")


def _open_maybe_gzip(path: str):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    return gzip.open(path, "rb") if magic == b"\x1f\x8b" else open(path, "rb")


# ----------------------------------------------------------------- MNIST ----

def parse_idx_images(path: str) -> np.ndarray:
    """idx3-ubyte (optionally gzipped) -> float32 [N, rows*cols] scaled to
    [-1, 1] (the reference's normalization, mnist.py:59-63)."""
    with _open_maybe_gzip(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise IOError(f"{path}: bad idx3 magic {magic} (want 2051)")
        buf = f.read(n * rows * cols)
        if len(buf) < n * rows * cols:
            raise IOError(f"{path}: truncated idx3 body")
        imgs = np.frombuffer(buf, np.uint8).reshape(n, rows * cols)
        return (imgs.astype(np.float32) / 255.0) * 2.0 - 1.0


def parse_idx_labels(path: str) -> np.ndarray:
    """idx1-ubyte (optionally gzipped) -> int32 [N]."""
    with _open_maybe_gzip(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise IOError(f"{path}: bad idx1 magic {magic} (want 2049)")
        buf = f.read(n)
        if len(buf) < n:
            raise IOError(f"{path}: truncated idx1 body")
        return np.frombuffer(buf, np.uint8).astype(np.int32)


def mnist_reader(images_path: str, labels_path: str):
    """Reader over real MNIST idx files — same sample schema as the
    synthetic dataset.mnist (image[784] float, int label). Files parse
    lazily on first iteration, then cache, so multi-pass training decodes
    the ~55MB idx bodies once."""
    cache = []

    def reader():
        if not cache:
            imgs = parse_idx_images(images_path)
            labels = parse_idx_labels(labels_path)
            if len(imgs) != len(labels):
                raise IOError("mnist: image/label count mismatch "
                              f"({len(imgs)} vs {len(labels)})")
            cache.append((imgs, labels))
        imgs, labels = cache[0]
        for i in range(len(imgs)):
            yield imgs[i], int(labels[i])
    return reader


# ----------------------------------------------------------------- CIFAR ----

def cifar_reader(archive_path: str, member_prefix: str = "data_batch"):
    """Reader over a real CIFAR tar.gz of pickled batches
    (cifar.py reader_creator: dict[b'data'] [N,3072] uint8,
    dict[b'labels']). Yields (image[3072] float in [-1,1], int label)."""
    def reader():
        with tarfile.open(archive_path, "r:*") as tar:
            names = sorted(m.name for m in tar.getmembers()
                           if member_prefix in m.name)
            if not names:
                raise IOError(f"{archive_path}: no members matching "
                              f"{member_prefix!r}")
            for name in names:
                batch = pickle.load(tar.extractfile(name), encoding="bytes")
                data = batch[b"data"].astype(np.float32) / 255.0 * 2.0 - 1.0
                labels = batch.get(b"labels", batch.get(b"fine_labels"))
                if labels is None:
                    raise IOError(f"{archive_path}:{name}: batch dict has "
                                  "neither b'labels' nor b'fine_labels' "
                                  "(corrupt or foreign pickle)")
                for i in range(len(data)):
                    yield data[i], int(labels[i])
    return reader


# ----------------------------------------------------------- CoNLL column ---

def parse_conll_columns(path: str, word_col: int = 0,
                        tag_col: int = -1) -> Iterator[Tuple[List[str], List[str]]]:
    """Classic CoNLL column corpus: one token per line, whitespace-separated
    columns, blank line ends a sentence (conll05.py corpus layout).
    Yields (words, tags) per sentence."""
    words: List[str] = []
    tags: List[str] = []
    with _open_maybe_gzip(path) as f:
        for raw in f:
            line = raw.decode("utf-8").strip()
            if not line:
                if words:
                    yield words, tags
                    words, tags = [], []
                continue
            cols = line.split()
            words.append(cols[word_col])
            tags.append(cols[tag_col])
    if words:
        yield words, tags


def build_dict(tokens: Iterator[str], min_count: int = 0,
               specials: Tuple[str, ...] = ("<unk>",)) -> Dict[str, int]:
    """Frequency-ordered token dict (dataset/common.py word-dict role)."""
    counts: Dict[str, int] = {}
    for t in tokens:
        counts[t] = counts.get(t, 0) + 1
    vocab = list(specials) + [
        t for t, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if c > min_count and t not in specials]
    return {t: i for i, t in enumerate(vocab)}


def conll_reader(path: str, word_dict: Optional[Dict[str, int]] = None,
                 tag_dict: Optional[Dict[str, int]] = None,
                 word_col: int = 0, tag_col: int = -1):
    """Reader over a real CoNLL column file: (word_ids, tag_ids) int lists
    — the conll05 sample schema. Dicts are built from the file when not
    given (pass the TRAIN dicts when reading test)."""
    sents = list(parse_conll_columns(path, word_col, tag_col))
    if word_dict is None:
        word_dict = build_dict(w for ws, _ in sents for w in ws)
    if tag_dict is None:
        tag_dict = build_dict((t for _, ts in sents for t in ts),
                              specials=())
    unk = word_dict.get("<unk>")

    def lookup_word(w):
        wid = word_dict.get(w, unk)
        if wid is None:
            raise ValueError(
                f"conll: word {w!r} not in the supplied word_dict and the "
                "dict has no '<unk>' entry — add one (build_dict does) or "
                "pass a dict covering this split")
        return wid

    def lookup_tag(t):
        tid = tag_dict.get(t)
        if tid is None:
            raise ValueError(
                f"conll: tag {t!r} not in the supplied tag_dict "
                f"({len(tag_dict)} tags) — tag sets must cover every split "
                "(build the dict over train+test or extend it)")
        return tid

    def reader():
        for ws, ts in sents:
            yield ([lookup_word(w) for w in ws],
                   [lookup_tag(t) for t in ts])
    reader.word_dict = word_dict
    reader.tag_dict = tag_dict
    return reader


# ------------------------------------------------------ parallel corpora ----

BOS, EOS, UNK = "<s>", "<e>", "<unk>"


def parallel_text_reader(src_path: str, trg_path: str,
                         src_dict: Optional[Dict[str, int]] = None,
                         trg_dict: Optional[Dict[str, int]] = None):
    """Reader over aligned plain-text files (wmt14.py corpus semantics):
    per line, whitespace-tokenized; yields the reference's NMT triple
    (src_ids, trg_ids_with_bos, trg_ids_with_eos)."""
    def lines(p):
        # keep blank lines so positions stay aligned; pairs where either
        # side is empty are dropped TOGETHER below
        with _open_maybe_gzip(p) as f:
            return [l.decode("utf-8").split() for l in f]

    src_all, trg_all = lines(src_path), lines(trg_path)
    if len(src_all) != len(trg_all):
        raise IOError(f"parallel corpus misaligned: {len(src_all)} src vs "
                      f"{len(trg_all)} trg lines")
    pairs = [(s, t) for s, t in zip(src_all, trg_all) if s and t]
    src_lines = [s for s, _ in pairs]
    trg_lines = [t for _, t in pairs]
    if src_dict is None:
        src_dict = build_dict((t for l in src_lines for t in l),
                              specials=(BOS, EOS, UNK))
    if trg_dict is None:
        trg_dict = build_dict((t for l in trg_lines for t in l),
                              specials=(BOS, EOS, UNK))
    s_unk, t_unk = src_dict[UNK], trg_dict[UNK]
    t_bos, t_eos = trg_dict[BOS], trg_dict[EOS]

    def reader():
        for s, t in zip(src_lines, trg_lines):
            sid = [src_dict.get(w, s_unk) for w in s]
            tid = [trg_dict.get(w, t_unk) for w in t]
            yield sid, [t_bos] + tid, tid + [t_eos]
    reader.src_dict = src_dict
    reader.trg_dict = trg_dict
    return reader
