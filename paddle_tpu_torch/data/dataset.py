"""Dataset zoo — synthetic, deterministic, egress-free stand-ins; a copy
of ``paddle_tpu/data/dataset.py`` (the same rows from the same seeds).

The reference ships downloaders for 11 datasets (python/paddle/v2/dataset/*:
mnist, cifar, imdb, imikolov, movielens, conll05, sentiment, uci_housing, wmt14,
flowers, voc2012, mq2007; cache in dataset/common.py). This environment has no
network, so each dataset here is a *deterministic synthetic generator with the
same sample schema and reader API* (``train()``/``test()`` reader creators) —
structured so models actually learn (class-conditional patterns, latent-factor
ratings, reversible translation), which is what the book-style end-to-end tests
need (SURVEY.md §4.4).
"""

from __future__ import annotations

import numpy as np

from .reader import Reader


def _state(seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed)


# ---------------------------------------------------------------- mnist ------
class mnist:
    """28x28 digit classification. Sample: (image[784] float in [-1,1], label)."""

    IMAGE_DIM, CLASSES = 784, 10

    @staticmethod
    def _make(n, seed):
        rs = _state(seed)
        protos = _state(1234).randn(10, 784).astype(np.float32)
        labels = rs.randint(0, 10, n)
        imgs = (0.7 * protos[labels] + 0.7 * rs.randn(n, 784)).astype(np.float32)
        imgs = np.tanh(imgs)
        return imgs, labels.astype(np.int32)

    @staticmethod
    def train(n: int = 2048) -> Reader:
        def reader():
            imgs, labels = mnist._make(n, 0)
            for i in range(n):
                yield imgs[i], int(labels[i])
        return reader

    @staticmethod
    def test(n: int = 512) -> Reader:
        def reader():
            imgs, labels = mnist._make(n, 1)
            for i in range(n):
                yield imgs[i], int(labels[i])
        return reader


# ---------------------------------------------------------------- cifar ------
class cifar:
    """32x32x3 image classification (cifar10 schema): (image[3072], label)."""

    CLASSES = 10

    @staticmethod
    def _make(n, seed):
        rs = _state(seed)
        protos = _state(99).randn(10, 3072).astype(np.float32)
        labels = rs.randint(0, 10, n)
        imgs = np.tanh(0.6 * protos[labels] + 0.8 * rs.randn(n, 3072)).astype(np.float32)
        return imgs, labels.astype(np.int32)

    @staticmethod
    def train10(n: int = 1024) -> Reader:
        def reader():
            imgs, labels = cifar._make(n, 10)
            for i in range(n):
                yield imgs[i], int(labels[i])
        return reader

    @staticmethod
    def test10(n: int = 256) -> Reader:
        def reader():
            imgs, labels = cifar._make(n, 11)
            for i in range(n):
                yield imgs[i], int(labels[i])
        return reader


# ----------------------------------------------------------- uci_housing -----
class uci_housing:
    """13-feature regression: (features[13], price[1])."""

    FEATURE_DIM = 13
    _W = _state(7).randn(13).astype(np.float32)

    @staticmethod
    def _make(n, seed):
        rs = _state(seed)
        x = rs.randn(n, 13).astype(np.float32)
        y = (x @ uci_housing._W + 0.1 * rs.randn(n)).astype(np.float32)
        return x, y[:, None]

    @staticmethod
    def train(n: int = 404) -> Reader:
        def reader():
            x, y = uci_housing._make(n, 20)
            for i in range(n):
                yield x[i], y[i]
        return reader

    @staticmethod
    def test(n: int = 102) -> Reader:
        def reader():
            x, y = uci_housing._make(n, 21)
            for i in range(n):
                yield x[i], y[i]
        return reader


# ---------------------------------------------------------------- imdb -------
class imdb:
    """Binary sentiment over id sequences: (word_ids list, label 0/1).

    Class-conditional unigram distributions -> linearly separable by embedding
    pooling, like the quick_start text-classification demo data.
    """

    VOCAB = 2000

    @staticmethod
    def _dists():
        rs = _state(5)
        base = rs.dirichlet(np.ones(imdb.VOCAB) * 0.1)
        tilt = rs.randn(imdb.VOCAB) * 2.0
        pos = base * np.exp(tilt)
        neg = base * np.exp(-tilt)
        return pos / pos.sum(), neg / neg.sum()

    @staticmethod
    def _make(n, seed, min_len=8, max_len=64):
        rs = _state(seed)
        pos, neg = imdb._dists()
        for _ in range(n):
            label = int(rs.randint(0, 2))
            ln = int(rs.randint(min_len, max_len + 1))
            dist = pos if label == 1 else neg
            ids = rs.choice(imdb.VOCAB, size=ln, p=dist).astype(np.int32)
            yield list(map(int, ids)), label

    @staticmethod
    def train(n: int = 1024) -> Reader:
        return lambda: imdb._make(n, 30)

    @staticmethod
    def test(n: int = 256) -> Reader:
        return lambda: imdb._make(n, 31)


# -------------------------------------------------------------- imikolov -----
class imikolov:
    """N-gram LM (word2vec book test schema): tuples of N consecutive ids from a
    synthetic order-1 Markov chain (so context genuinely predicts the target)."""

    VOCAB = 512

    @staticmethod
    def _chain():
        rs = _state(40)
        T = rs.dirichlet(np.ones(imikolov.VOCAB) * 0.05, size=imikolov.VOCAB)
        return T

    @staticmethod
    def _make(n, seed, ngram=5):
        rs = _state(seed)
        T = imikolov._chain()
        w = int(rs.randint(imikolov.VOCAB))
        seq = [w]
        for _ in range(n + ngram):
            w = int(rs.choice(imikolov.VOCAB, p=T[w]))
            seq.append(w)
        for i in range(n):
            yield tuple(seq[i:i + ngram])

    @staticmethod
    def train(n: int = 2048, ngram: int = 5) -> Reader:
        return lambda: imikolov._make(n, 41, ngram)

    @staticmethod
    def test(n: int = 256, ngram: int = 5) -> Reader:
        return lambda: imikolov._make(n, 42, ngram)


# -------------------------------------------------------------- movielens ----
class movielens:
    """Recommender schema: (user_id, gender, age, job, movie_id, category_multihot,
    rating). Ratings from latent factors -> learnable."""

    USERS, MOVIES, CATEGORIES, JOBS, AGES = 944, 1683, 19, 21, 7

    @staticmethod
    def _factors():
        rs = _state(50)
        return (rs.randn(movielens.USERS, 8).astype(np.float32),
                rs.randn(movielens.MOVIES, 8).astype(np.float32))

    @staticmethod
    def _make(n, seed):
        rs = _state(seed)
        U, M = movielens._factors()
        for _ in range(n):
            u = int(rs.randint(movielens.USERS))
            m = int(rs.randint(movielens.MOVIES))
            cats = sorted(set(map(int, rs.randint(0, movielens.CATEGORIES,
                                                  rs.randint(1, 4)))))
            score = float(U[u] @ M[m]) / 8.0
            rating = float(np.clip(3.0 + 2.0 * np.tanh(score) + 0.2 * rs.randn(),
                                   1.0, 5.0))
            yield (u, int(rs.randint(0, 2)), int(rs.randint(movielens.AGES)),
                   int(rs.randint(movielens.JOBS)), m, cats, rating)

    @staticmethod
    def train(n: int = 2048) -> Reader:
        return lambda: movielens._make(n, 51)

    @staticmethod
    def test(n: int = 256) -> Reader:
        return lambda: movielens._make(n, 52)


# ---------------------------------------------------------------- wmt14 ------
class wmt14:
    """Seq2seq NMT schema: (src_ids, trg_ids_in, trg_ids_out) with <s>=0, <e>=1,
    <unk>=2. Synthetic task: target = reversed source mapped through a fixed
    permutation — non-trivial but exactly learnable, standard toy-NMT practice."""

    SRC_VOCAB, TRG_VOCAB = 300, 300
    START, END, UNK = 0, 1, 2

    @staticmethod
    def _perm():
        return _state(60).permutation(np.arange(3, wmt14.TRG_VOCAB))

    @staticmethod
    def _make(n, seed, min_len=4, max_len=16):
        rs = _state(seed)
        perm = wmt14._perm()
        for _ in range(n):
            ln = int(rs.randint(min_len, max_len + 1))
            src = rs.randint(3, wmt14.SRC_VOCAB, ln).astype(np.int64)
            trg = perm[src[::-1] - 3]
            trg_in = np.concatenate([[wmt14.START], trg])
            trg_out = np.concatenate([trg, [wmt14.END]])
            yield (list(map(int, src)), list(map(int, trg_in)),
                   list(map(int, trg_out)))

    @staticmethod
    def train(n: int = 2048) -> Reader:
        return lambda: wmt14._make(n, 61)

    @staticmethod
    def test(n: int = 256) -> Reader:
        return lambda: wmt14._make(n, 62)


# --------------------------------------------------------------- conll05 -----
class conll05:
    """Sequence-labeling schema (SRL/NER style): (word_ids, tag_ids) from an HMM
    so tag context matters — exercises the CRF layers."""

    VOCAB, TAGS = 800, 9

    @staticmethod
    def _hmm():
        rs = _state(70)
        trans = rs.dirichlet(np.ones(conll05.TAGS) * 0.2, size=conll05.TAGS)
        emit = rs.dirichlet(np.ones(conll05.VOCAB) * 0.05, size=conll05.TAGS)
        return trans, emit

    @staticmethod
    def _make(n, seed, min_len=5, max_len=30):
        rs = _state(seed)
        trans, emit = conll05._hmm()
        for _ in range(n):
            ln = int(rs.randint(min_len, max_len + 1))
            t = int(rs.randint(conll05.TAGS))
            words, tags = [], []
            for _ in range(ln):
                words.append(int(rs.choice(conll05.VOCAB, p=emit[t])))
                tags.append(t)
                t = int(rs.choice(conll05.TAGS, p=trans[t]))
            yield words, tags

    @staticmethod
    def train(n: int = 512) -> Reader:
        return lambda: conll05._make(n, 71)

    @staticmethod
    def test(n: int = 128) -> Reader:
        return lambda: conll05._make(n, 72)


# --------------------------------------------------------------- sentiment ---
class sentiment(imdb):
    """Alias schema of imdb (the reference ships both, dataset/sentiment.py)."""


# ----------------------------------------------------------------- mq2007 ----
class mq2007:
    """Learning-to-rank schema: (query_id, features[46], relevance 0..2),
    grouped by query; relevance from a hidden linear scorer."""

    FEATURES = 46
    _W = _state(80).randn(46).astype(np.float32)

    @staticmethod
    def _make(n_queries, seed, docs_per_query=10):
        rs = _state(seed)
        for q in range(n_queries):
            x = rs.randn(docs_per_query, mq2007.FEATURES).astype(np.float32)
            score = x @ mq2007._W + 0.3 * rs.randn(docs_per_query)
            rel = np.digitize(score, np.quantile(score, [0.5, 0.8])).astype(np.int32)
            for d in range(docs_per_query):
                yield q, x[d], int(rel[d])

    @staticmethod
    def train(n_queries: int = 128) -> Reader:
        return lambda: mq2007._make(n_queries, 81)

    @staticmethod
    def test(n_queries: int = 32) -> Reader:
        return lambda: mq2007._make(n_queries, 82)


# ------------------------------------------------------------------ criteo ---
class criteo:
    """CTR schema (DeepFM target): (dense[13], sparse_ids[26], click) — the
    Criteo layout; click prob from a factorization-machine teacher so FM-style
    models fit it."""

    DENSE, FIELDS, HASH = 13, 26, 1000

    @staticmethod
    def _teacher():
        rs = _state(90)
        return (rs.randn(criteo.HASH).astype(np.float32) * 0.3,
                rs.randn(criteo.HASH, 4).astype(np.float32) * 0.3,
                rs.randn(criteo.DENSE).astype(np.float32) * 0.5)

    @staticmethod
    def _make(n, seed):
        rs = _state(seed)
        w1, v, wd = criteo._teacher()
        for _ in range(n):
            dense = rs.randn(criteo.DENSE).astype(np.float32)
            ids = rs.randint(0, criteo.HASH, criteo.FIELDS).astype(np.int32)
            lin = w1[ids].sum() + dense @ wd
            vi = v[ids]
            fm = 0.5 * (np.square(vi.sum(0)) - np.square(vi).sum(0)).sum()
            p = 1.0 / (1.0 + np.exp(-(lin + fm)))
            yield dense, list(map(int, ids)), int(rs.rand() < p)

    @staticmethod
    def train(n: int = 2048) -> Reader:
        return lambda: criteo._make(n, 91)

    @staticmethod
    def test(n: int = 256) -> Reader:
        return lambda: criteo._make(n, 92)


# --------------------------------------------------------------- flowers -----
class flowers:
    """Oxford-102 flowers schema (dataset/flowers.py): readers yield
    (HWC uint8 image, label in [0, 102)) through the standard train/test
    mapper pipeline (resize-short 256 -> crop 224 -> normalize handled by the
    caller's mapper, as in flowers.default_mapper)."""

    CLASSES = 102
    HW = 64          # synthetic images are small; schema (HWC uint8) matches

    @staticmethod
    def _make(n, seed):
        rs = _state(seed)
        protos = _state(77).randint(0, 255, (flowers.CLASSES, 8, 8, 3))
        labels = rs.randint(0, flowers.CLASSES, n)
        imgs = []
        for i in range(n):
            base = protos[labels[i]].astype(np.float32)
            up = np.kron(base, np.ones((flowers.HW // 8, flowers.HW // 8, 1)))
            noise = rs.randn(flowers.HW, flowers.HW, 3) * 12
            imgs.append(np.clip(up + noise, 0, 255).astype(np.uint8))
        return imgs, labels.astype(np.int32)

    @staticmethod
    def train(n: int = 512, mapper=None) -> Reader:
        def reader():
            imgs, labels = flowers._make(n, 70)
            for im, lb in zip(imgs, labels):
                sample = (im, int(lb))
                yield mapper(sample) if mapper else sample
        return reader

    @staticmethod
    def test(n: int = 128, mapper=None) -> Reader:
        def reader():
            imgs, labels = flowers._make(n, 71)
            for im, lb in zip(imgs, labels):
                sample = (im, int(lb))
                yield mapper(sample) if mapper else sample
        return reader

    valid = test


# --------------------------------------------------------------- voc2012 -----
class voc2012:
    """VOC2012 segmentation schema (dataset/voc2012.py): readers yield
    (HWC uint8 image, HW int32 mask with classes in [0, 21))."""

    CLASSES = 21
    HW = 64

    @staticmethod
    def _make(n, seed):
        rs = _state(seed)
        samples = []
        for _ in range(n):
            img = rs.randint(0, 255, (voc2012.HW, voc2012.HW, 3)).astype(np.uint8)
            mask = np.zeros((voc2012.HW, voc2012.HW), np.int32)
            # a few rectangular object regions with class-correlated pixels
            for _ in range(rs.randint(1, 4)):
                c = rs.randint(1, voc2012.CLASSES)
                y, x = rs.randint(0, voc2012.HW - 16, 2)
                h, w = rs.randint(8, 16, 2)
                mask[y:y + h, x:x + w] = c
                img[y:y + h, x:x + w] = (c * 11) % 255
            samples.append((img, mask))
        return samples

    @staticmethod
    def train(n: int = 256) -> Reader:
        def reader():
            for img, mask in voc2012._make(n, 80):
                yield img, mask
        return reader

    @staticmethod
    def test(n: int = 64) -> Reader:
        def reader():
            for img, mask in voc2012._make(n, 81):
                yield img, mask
        return reader

    val = test
