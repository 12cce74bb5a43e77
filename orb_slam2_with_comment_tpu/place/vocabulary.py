"""Binary BoW vocabulary: hierarchical k-majority tree as flat arrays.

JAX rebuild of DBoW2's TemplatedVocabulary (reference:
Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1218-1259 transform,
:1127-1194 tf-idf weighting and L1 scoring via ScoringObject): the k^L
tree becomes three arrays (node descriptors, children index table, leaf
word ids); `transform` descends all N descriptors through all L levels in
one vectorized arg-min-Hamming sweep, and keyframe BoW vectors are DENSE
[n_words] tf-idf rows so database scoring against every keyframe at once
is a single batched abs-diff reduction ("batched bitcount scoring",
BASELINE.json north star — replaces the inverted file).

The reference ships a 1M-word vocabulary trained on Flickr1M
(ORBvoc.txt, absent from this mount — SURVEY §7.7); `train_vocabulary`
builds one by hierarchical binary k-means (bitwise-majority means) over
descriptors harvested from the target image domain.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.hamming import hamming_pair


class Vocabulary(NamedTuple):
    node_desc: jax.Array  # [n_nodes, 8] uint32
    children: jax.Array  # [n_nodes, k] int32, -1 = none (root = node 0)
    leaf_word: jax.Array  # [n_nodes] int32 word id or -1
    word_weight: jax.Array  # [n_words] f32 idf weight
    k: int
    levels: int
    n_words: int


def _popcount_np(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _kmajority(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-means with bitwise-majority means (FORB::meanValue
    semantics, reference: FORB.cpp:107-143). descs [M, 8] uint32.

    Distances run on packed bytes through a popcount LUT — peak memory is
    [M, k, 32] uint8 instead of the [M, k, 256] bool of the unpacked
    formulation, which matters at the ~10^5-descriptor corpora the 10k-word
    tree is trained on."""
    M = len(descs)
    k = min(k, M)
    centers = descs[rng.choice(M, k, replace=False)]
    dbytes = descs.view(np.uint8).reshape(M, 32)
    assign = np.zeros(M, np.int64)
    for _ in range(iters):
        cbytes = centers.view(np.uint8).reshape(k, 32)
        d = _POPCNT8[np.bitwise_xor(dbytes[:, None, :],
                                    cbytes[None, :, :])].sum(
            -1, dtype=np.int32)  # [M, k]
        assign = d.argmin(1)
        new = []
        for j in range(k):
            sel = dbytes[assign == j]
            if len(sel) == 0:
                new.append(descs[rng.randint(M)].view(np.uint8).reshape(32))
                continue
            selbits = np.unpackbits(sel, axis=-1)
            new.append(np.packbits(
                (selbits.mean(0) >= 0.5).astype(np.uint8)))
        centers = np.stack(new).view(np.uint32).reshape(k, 8)
    return centers, assign


def train_vocabulary(descs: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0) -> Vocabulary:
    """Hierarchical k-majority training (reference DBoW2 create())."""
    rng = np.random.RandomState(seed)
    descs = np.asarray(descs, np.uint32).reshape(-1, 8)
    node_desc = [np.zeros(8, np.uint32)]  # root placeholder
    children: list[list[int]] = [[]]
    leaf_word = [-1]
    leaf_counts: list[int] = []

    def split(node_id, subset, depth):
        if depth == levels or len(subset) <= k:
            # make current node's children the leaves directly from subset
            leaf_id = len(leaf_counts)
            leaf_word[node_id] = leaf_id
            leaf_counts.append(max(len(subset), 1))
            return
        centers, assign = _kmajority(subset, k, rng)
        for j in range(len(centers)):
            child_id = len(node_desc)
            node_desc.append(centers[j])
            children.append([])
            leaf_word.append(-1)
            children[node_id].append(child_id)
            split(child_id, subset[assign == j], depth + 1)

    split(0, descs, 0)
    n_nodes = len(node_desc)
    n_words = len(leaf_counts)
    ch = np.full((n_nodes, k), -1, np.int32)
    for i, c in enumerate(children):
        ch[i, :len(c)] = c
    # idf weights (reference: TemplatedVocabulary TF_IDF weighting)
    counts = np.asarray(leaf_counts, np.float64)
    idf = np.log(len(descs) / np.clip(counts, 1, None)).astype(np.float32)
    return Vocabulary(
        jnp.asarray(np.stack(node_desc)), jnp.asarray(ch),
        jnp.asarray(np.asarray(leaf_word, np.int32)),
        jnp.asarray(idf), k, levels, n_words,
    )


def save_vocabulary(voc: Vocabulary, path: str) -> None:
    """Persist a trained vocabulary as flat arrays (npz)."""
    np.savez_compressed(
        path if path.endswith(".npz") else path + ".npz",
        node_desc=np.asarray(voc.node_desc), children=np.asarray(voc.children),
        leaf_word=np.asarray(voc.leaf_word),
        word_weight=np.asarray(voc.word_weight),
        k=voc.k, levels=voc.levels, n_words=voc.n_words)


def load_vocabulary(path: str, as_numpy: bool = False) -> Vocabulary:
    """Load a vocabulary saved by save_vocabulary.

    as_numpy=True keeps the arrays host-side (numpy): traced code then
    embeds them as compile-time constants. Use this whenever the
    vocabulary is CLOSED OVER by a jitted program.
    """
    z = np.load(path)
    conv = (lambda a: np.asarray(a)) if as_numpy else jnp.asarray
    return Vocabulary(
        conv(z["node_desc"]), conv(z["children"]), conv(z["leaf_word"]),
        conv(z["word_weight"]), int(z["k"]), int(z["levels"]),
        int(z["n_words"]))


def load_default_vocabulary(as_numpy: bool = False) -> Vocabulary:
    """The packaged default vocabulary (our ORBvoc.txt counterpart,
    trained offline by scripts/train_vocab.py; reference: Vocabulary/
    ORBvoc.txt loaded at System startup, System.cc:71)."""
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "vocab_default.npz")
    return load_vocabulary(path, as_numpy=as_numpy)


def transform(voc: Vocabulary, desc: jax.Array, valid: jax.Array) -> jax.Array:
    """Descend the tree: [N, 8] descriptors -> [N] word ids (-1 invalid)."""
    N = desc.shape[0]
    node = jnp.zeros(N, jnp.int32)
    # jnp.asarray: numpy-backed vocabularies (load_vocabulary(as_numpy=True))
    # become compile-time constants here; device-backed ones pass through.
    children = jnp.asarray(voc.children)
    node_desc = jnp.asarray(voc.node_desc)
    leaf_word = jnp.asarray(voc.leaf_word)

    def body(_, node):
        ch = children[node]  # [N, k]
        ch_desc = node_desc[jnp.clip(ch, 0)]  # [N, k, 8]
        d = hamming_pair(desc[:, None, :], ch_desc)  # [N, k]
        d = jnp.where(ch >= 0, d, 10_000)
        best = jnp.argmin(d, axis=1)
        nxt = jnp.take_along_axis(ch, best[:, None], axis=1)[:, 0]
        # stay put at leaves (no children)
        return jnp.where(nxt >= 0, nxt, node)

    node = jax.lax.fori_loop(0, voc.levels, body, node)
    word = leaf_word[node]
    return jnp.where(valid, word, -1)


def bow_vectors(voc: Vocabulary, words: jax.Array, valid: jax.Array) -> jax.Array:
    """[..., N] word ids -> dense L1-normalized tf-idf vectors [..., W]."""
    W = voc.n_words
    ok = valid & (words >= 0)
    onehot = jax.nn.one_hot(jnp.where(ok, words, W), W + 1, dtype=jnp.float32)
    tf = jnp.sum(onehot, axis=-2)[..., :W]
    v = tf * jnp.asarray(voc.word_weight)
    return v / jnp.clip(jnp.sum(jnp.abs(v), axis=-1, keepdims=True), 1e-9, None)


def score_l1(v: jax.Array, db: jax.Array) -> jax.Array:
    """DBoW2 L1 score (reference: ScoringObject L1Scoring): both inputs
    L1-normalized; s = 1 - 0.5 * |v - w|_1, batched over db rows [K, W]."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v[None, :] - db), axis=-1)


# --- sparse BoW rows -------------------------------------------------------
#
# Dense [K, n_words] rows cap the vocabulary at ~10^4 words (the reference
# tree is 10^6 leaves, TemplatedVocabulary.h:109). A keyframe touches at
# most n_feat distinct words, so its tf-idf vector is stored exactly as
# (word_id, weight) pairs [T] — memory O(K*T) independent of vocabulary
# size, like DBoW2's sparse BowVector. For L1-normalized vectors the L1
# score reduces to histogram intersection over COMMON words:
#   1 - 0.5*|v-w|_1 = sum_common min(v_i, w_i)
# which needs one dense scratch of the QUERY only ([n_words], 4 MB at 10^6
# words) — never a [K, n_words] matrix.


def bow_sparse(voc: Vocabulary, words: jax.Array, valid: jax.Array,
               cap: int) -> tuple[jax.Array, jax.Array]:
    """[N] word ids -> sparse L1-normalized tf-idf row: (idx [cap] int32
    word ids, -1 padded; w [cap] f32). cap >= N is lossless (<= N distinct
    words exist); smaller caps drop the highest word ids."""
    N = words.shape[0]
    ok = valid & (words >= 0)
    sw = jnp.sort(jnp.where(ok, words, jnp.int32(2**31 - 1)))
    first = jnp.concatenate([jnp.ones(1, bool), sw[1:] != sw[:-1]])
    is_word = sw < 2**31 - 1
    # run lengths via searchsorted on the sorted array
    start = jnp.searchsorted(sw, sw, side="left")
    end = jnp.searchsorted(sw, sw, side="right")
    tf = (end - start).astype(jnp.float32)
    keep = first & is_word
    # pack unique words to a [cap] prefix (order-stable by word id);
    # cap > N pads with empty slots
    order = jnp.argsort(~keep, stable=True).astype(jnp.int32)[:cap]
    got = keep[order]
    if cap > N:
        pad = cap - N
        order = jnp.concatenate([order, jnp.zeros(pad, jnp.int32)])
        got = jnp.concatenate([got, jnp.zeros(pad, bool)])
    idx = jnp.where(got, sw[order], -1).astype(jnp.int32)
    w = jnp.where(got, tf[order], 0.0)
    w = w * jnp.asarray(voc.word_weight)[jnp.clip(idx, 0)]
    w = jnp.where(got, w, 0.0)
    return idx, w / jnp.clip(jnp.sum(w), 1e-9, None)


def score_l1_sparse(q_idx: jax.Array, q_w: jax.Array, rows_idx: jax.Array,
                    rows_w: jax.Array, n_words: int) -> jax.Array:
    """L1 score of one sparse query against K sparse rows: [K] scores.
    q_idx/q_w [T]; rows_idx/rows_w [K, T]. Empty rows score 0."""
    # pad entries (-1) scatter into a sacrificial overflow slot — clipping
    # them to 0 would overwrite word 0's weight
    safe = jnp.where(q_idx >= 0, q_idx, n_words)
    scratch = jnp.zeros(n_words + 1, jnp.float32).at[safe].set(q_w)
    qv = scratch[jnp.clip(rows_idx, 0)]  # [K, T]
    rv = jnp.where(rows_idx >= 0, rows_w, 0.0)
    return jnp.sum(jnp.minimum(qv, rv), axis=-1)
