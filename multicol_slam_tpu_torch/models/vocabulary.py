"""Binary-descriptor vocabulary: a k-ary k-medians tree and the batched
BoW transform (the DBoW2 replacement).

Port of ``multicol_slam_tpu/models/vocabulary.py`` (reference
TemplatedVocabulary::transform, ThirdParty/DBoW2/TemplatedVocabulary.h:
135-160; FORB::meanValue; L1 scoring, ScoringObject.cpp). The tree has an
explicit child table, so trained complete trees and loaded DBoW2 trees
(leaves at varying depth) share one descent. Training, BoW vectors and
file I/O are host numpy, copied from the JAX package so a seed gives the
same tree bit for bit; the descent runs in torch on the descriptors'
device, one level at a time for every descriptor at once. Centroids are
int32 bit patterns, as packed descriptors are everywhere in the port.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch


class Vocabulary(NamedTuple):
    """children[n] lists node n's children (-1 padded); word_of_node maps
    leaf nodes to word ids (-1 for interior nodes)."""

    centroids: torch.Tensor     # (n_nodes, W) int32 bit patterns
    children: torch.Tensor      # (n_nodes, k) int32
    word_of_node: torch.Tensor  # (n_nodes,) int32
    k: int
    levels: int
    n_words_: int
    weights: torch.Tensor       # (n_words,) float32 idf weights

    @property
    def n_words(self) -> int:
        return self.n_words_

    def to(self, device) -> "Vocabulary":
        return self._replace(centroids=self.centroids.to(device),
                             children=self.children.to(device),
                             word_of_node=self.word_of_node.to(device),
                             weights=self.weights.to(device))


def _from_numpy(centroids, children, word_of_node, k, levels, n_words, weights,
                device=None) -> Vocabulary:
    t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(device)
    return Vocabulary(
        centroids=torch.from_numpy(np.array(centroids, np.uint32).view(np.int32)).to(device),
        children=t(children, np.int32), word_of_node=t(word_of_node, np.int32),
        k=int(k), levels=int(levels), n_words_=int(n_words),
        weights=t(weights, np.float32))


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """FORB::meanValue: per-bit majority vote over (N, W) uint32."""
    bits = np.unpackbits(descs.view(np.uint8), axis=1)
    mean = bits.mean(0) >= 0.5
    return np.packbits(mean.astype(np.uint8)).view(np.uint32)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, W) x (M, W) -> (N, M) Hamming distances (numpy popcount)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8).reshape(x.shape[0], x.shape[1], -1),
                         axis=2).sum(2)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 4,
                     seed: int = 0, kmeans_iters: int = 8,
                     doc_ids: np.ndarray | None = None) -> Vocabulary:
    """Hierarchical binary k-medians (DBoW2 create): each node's
    descriptors split into k clusters, ``levels`` deep, with bit-majority
    centroids and random distinct initial picks from ``default_rng(seed)``.
    descriptors: (N, W) uint32 (int32 bit patterns are viewed as uint32).

    idf is log(n_docs / docs containing the word) with ``doc_ids`` (N,)
    naming each descriptor's training image (TemplatedVocabulary::
    setNodeWeights); without it every descriptor is its own document.
    Returns the tree on the CPU."""
    descriptors = np.ascontiguousarray(descriptors).view(np.uint32)
    rng = np.random.default_rng(seed)
    W = descriptors.shape[1]
    n_nodes = (k ** (levels + 1) - 1) // (k - 1)
    centroids = np.zeros((n_nodes, W), np.uint32)
    children = np.full((n_nodes, k), -1, np.int32)
    word_of_node = np.full(n_nodes, -1, np.int32)

    assignments = {0: descriptors}
    for _ in range(levels):
        next_assign = {}
        for node, descs in assignments.items():
            if len(descs) == 0:
                continue
            kk = min(k, len(descs))
            idx = rng.choice(len(descs), kk, replace=False)
            cents = descs[idx].copy()
            for _ in range(kmeans_iters):
                lab = _hamming_np(descs, cents).argmin(1)
                new = np.stack([_bit_majority(descs[lab == c]) if (lab == c).any()
                                else cents[c] for c in range(kk)])
                if (new == cents).all():
                    break
                cents = new
            lab = _hamming_np(descs, cents).argmin(1)
            for c in range(kk):
                child = node * k + 1 + c
                centroids[child] = cents[c]
                children[node, c] = child
                next_assign[child] = descs[lab == c]
        assignments = next_assign

    # words: the deepest nodes created, in node order
    leaf_nodes = sorted(assignments.keys())
    for w, n in enumerate(leaf_nodes):
        word_of_node[n] = w
    n_words = len(leaf_nodes)
    voc = _from_numpy(centroids, children, word_of_node, k, levels, n_words,
                      np.ones(n_words, np.float32))
    words = transform_words(voc, torch.from_numpy(descriptors.view(np.int32)),
                            torch.ones(len(descriptors), dtype=torch.bool))[0].numpy()
    got = words >= 0
    word_counts = np.zeros(n_words, np.int64)
    if doc_ids is None:
        np.add.at(word_counts, words[got], 1)
        n_docs = max(len(descriptors), 1)
    else:
        doc_ids = np.asarray(doc_ids)
        pairs = np.unique(np.stack([words[got], doc_ids[got]], 1), axis=0)
        np.add.at(word_counts, pairs[:, 0], 1)
        n_docs = max(len(np.unique(doc_ids)), 1)
    idf = np.log(n_docs / np.maximum(word_counts, 1)).astype(np.float32)
    idf[word_counts == 0] = 0.0
    return voc._replace(weights=torch.from_numpy(idf))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values holding 32-bit words (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def transform_words(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
                    levelsup: int = 2):
    """(N, W) int32 packed descriptors -> (word id (N,), node ``levelsup``
    levels above the leaves (N,)), both int32; invalid rows get word -1.

    The descent of ``_transform_impl`` (vocabulary.py:148-169 of the JAX
    package): at each level every descriptor takes the child at the least
    Hamming distance, the first on ties, and stays where a node has no
    children. The node at ``levelsup`` plays DBoW2's FeatureVector role."""
    levelsup = min(levelsup, voc.levels - 1)
    words32 = desc.to(torch.int64) & 0xFFFFFFFF
    cents32 = voc.centroids.to(torch.int64) & 0xFFFFFFFF
    children = voc.children.long()
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    node_up = node
    for level in range(voc.levels):
        idx = children[node]                                    # (N, k)
        has_child = idx >= 0
        idx_safe = torch.clamp(idx, min=0)
        d = _popcount32(cents32[idx_safe] ^ words32[:, None, :]).sum(-1)
        d = torch.where(has_child, d, torch.full_like(d, 1 << 20))
        best = torch.argmin(d, 1)
        nxt = torch.gather(idx_safe, 1, best[:, None])[:, 0]
        node = torch.where(has_child.any(1), nxt, node)
        if level == voc.levels - levelsup - 1:
            node_up = node
    word = torch.where(valid, voc.word_of_node[node], torch.full_like(node, -1).to(torch.int32))
    return word.to(torch.int32), node_up.to(torch.int32)


def bow_vector(voc: Vocabulary, words) -> dict[int, float]:
    """Sparse L1-normalized tf-idf BoW vector (DBoW2 TF_IDF, L1) of host
    word ids."""
    words = np.asarray(words)
    words = words[words >= 0]
    if len(words) == 0:
        return {}
    ids, counts = np.unique(words, return_counts=True)
    w = counts.astype(np.float64) * voc.weights.cpu().numpy()[ids]
    total = w.sum()
    if total <= 0:
        return {}
    return {int(i): float(v / total) for i, v in zip(ids, w) if v > 0}


def bow_score_l1(v1: dict[int, float], v2: dict[int, float]) -> float:
    """DBoW2's L1 score, 1 - 0.5 |v1 - v2|_1 for L1-normalized vectors
    (ScoringObject.cpp)."""
    if not v1 or not v2:
        return 0.0
    s = 0.0
    for k_, a in v1.items():
        b = v2.get(k_)
        if b is not None:
            s += abs(a) + abs(b) - abs(a - b)
    return 0.5 * s


def save_vocabulary(voc: Vocabulary, path: str):
    """The JAX package's npz layout (centroids as uint32), so either
    package loads the other's files."""
    np.savez_compressed(
        path, centroids=voc.centroids.cpu().numpy().view(np.uint32),
        children=voc.children.cpu().numpy(), word_of_node=voc.word_of_node.cpu().numpy(),
        k=voc.k, levels=voc.levels, n_words=voc.n_words_,
        weights=voc.weights.cpu().numpy())


def load_vocabulary(path: str) -> Vocabulary:
    z = np.load(path)
    return _from_numpy(z["centroids"], z["children"], z["word_of_node"], z["k"],
                       z["levels"], z["n_words"], z["weights"])


def load_dbow2_yaml(path: str) -> Vocabulary:
    """A DBoW2 OpenCV-YAML vocabulary (the reference loads
    small_orb_omni_voc_9_6.yml with cv::FileStorage, cSystem.cpp:60-63):
    nodeId / parentId / weight / descriptor entries rebuild the child
    table; words are the leaves in node-id order (DBoW2 createWords)."""
    with open(path) as f:
        text = f.read()
    k = int(re.search(r"^\s*k:\s*(\d+)", text, re.M).group(1))
    L = int(re.search(r"^\s*L:\s*(\d+)", text, re.M).group(1))
    node_pat = re.compile(
        r"nodeId:\s*(\d+),\s*parentId:\s*(\d+),\s*weight:\s*([0-9.eE+-]+),"
        r"\s*descriptor:\s*\"([0-9 ]+)\"", re.S)
    nodes = []
    for mm in node_pat.finditer(text):
        dbytes = np.asarray([int(b) for b in mm.group(4).split()], np.uint8)
        nodes.append((int(mm.group(1)), int(mm.group(2)), float(mm.group(3)), dbytes))
    n_nodes = max(n[0] for n in nodes) + 1
    W = len(nodes[0][3]) // 4
    centroids = np.zeros((n_nodes, W), np.uint32)
    weights_by_node = np.zeros(n_nodes, np.float32)
    children = np.full((n_nodes, k), -1, np.int32)
    child_count = np.zeros(n_nodes, np.int32)
    for nid, pid, wt, dbytes in nodes:
        centroids[nid] = dbytes.view(np.uint32)
        weights_by_node[nid] = wt
        if child_count[pid] < k:
            children[pid, child_count[pid]] = nid
            child_count[pid] += 1
    is_leaf = child_count == 0
    is_leaf[0] = False
    word_of_node = np.full(n_nodes, -1, np.int32)
    leaf_ids = np.nonzero(is_leaf)[0]
    word_of_node[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
    return _from_numpy(centroids, children, word_of_node, k, L, len(leaf_ids),
                       weights_by_node[leaf_ids])
