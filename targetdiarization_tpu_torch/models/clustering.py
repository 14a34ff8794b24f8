"""Speaker clustering in numpy and scipy, without scikit-learn.

The JAX package clusters with scikit-learn, which the card's machine does
not have:
- `agglomerative_cosine_average` gives the labels of
  `sklearn.cluster.AgglomerativeClustering(metric="cosine",
  linkage="average").fit_predict`, numbering included: the tree is
  scipy's average linkage on cosine distances; with a distance threshold
  the cluster count is one more than the merges at or above it; the tree
  is cut as sklearn's `_hc_cut` does, which numbers the clusters in the
  order of its heap of node ids.
- `hdbscan_labels` is `sklearn.cluster.HDBSCAN` with its defaults
  (Euclidean metric, min_samples = min_cluster_size with a point counted
  among its own neighbours, excess-of-mass selection, no single cluster):
  core distances, Prim's minimum spanning tree of the mutual reachability
  distances, the single-linkage tree, the condensed tree, cluster
  stabilities, selection and labelling, each step as sklearn's Cython
  does it. Noise is -1.
"""

from __future__ import annotations

import heapq

import numpy as np
from scipy.cluster import hierarchy


# ---------------- agglomerative (average linkage, cosine) ----------------


def _descendants(node: int, children: np.ndarray, n_leaves: int) -> list:
    out, todo = [], [node]
    while todo:
        n = todo.pop()
        if n < n_leaves:
            out.append(n)
        else:
            todo.extend(children[n - n_leaves])
    return out


def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """Labels of the tree cut into n_clusters: the root's subtrees are split
    largest node first; cluster i is the i-th node of the heap's list."""
    nodes = [-(int(max(children[-1])) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -int(these[0]))
        heapq.heappushpop(nodes, -int(these[1]))
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        label[_descendants(-node, children, n_leaves)] = i
    return label


def agglomerative_cosine_average(x: np.ndarray, n_clusters: int | None = None,
                                 distance_threshold: float | None = None) -> np.ndarray:
    """Average-linkage clustering of the rows of x on cosine distance, into
    n_clusters, or merging only below distance_threshold (exactly one of
    the two)."""
    if (n_clusters is None) == (distance_threshold is None):
        raise ValueError("give exactly one of n_clusters and distance_threshold")
    x = np.asarray(x)
    if x.ndim != 2 or len(x) < 2:
        raise ValueError(f"need at least two samples, got shape {x.shape}")
    if np.any(~np.any(x, axis=1)):
        raise ValueError("cosine distance is undefined for a zero vector")
    z = hierarchy.linkage(x, method="average", metric="cosine")
    children = z[:, :2].astype(int)
    if distance_threshold is not None:
        n_clusters = int(np.count_nonzero(z[:, 2] >= distance_threshold)) + 1
    if n_clusters > len(x):
        raise ValueError(f"cannot make {n_clusters} clusters of {len(x)} samples")
    return _hc_cut(n_clusters, children, len(x))


# ---------------- HDBSCAN ----------------


def _euclid(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Euclidean distance over the last axis, the squares summed left to
    right in float64 as sklearn's distance metric sums them."""
    return np.sqrt(np.cumsum((a - b) ** 2, axis=-1)[..., -1])


def _mst_prim(x: np.ndarray, core: np.ndarray) -> np.ndarray:
    """Edges (source, target, mutual reachability) of Prim's spanning tree
    from node 0, in the order and with the tie rules of sklearn's
    `mst_from_data_matrix`."""
    n = len(x)
    in_tree = np.zeros(n, bool)
    min_reach = np.full(n, np.inf)
    sources = np.ones(n, np.int64)
    edges = np.zeros((n - 1, 3))
    current = 0
    for i in range(n - 1):
        in_tree[current] = True
        new_reach, source, new_node = np.finfo(np.float64).max, 0, 0
        d = _euclid(x, x[current])
        for j in range(n):
            if in_tree[j]:
                continue
            mr = max(core[current], core[j], d[j])
            if mr < min_reach[j]:
                min_reach[j], sources[j] = mr, current
                if mr < new_reach:
                    new_reach, source, new_node = mr, current, j
            elif min_reach[j] < new_reach:
                new_reach, source, new_node = min_reach[j], sources[j], j
        edges[i] = (source, new_node, new_reach)
        current = new_node
    return edges


def _single_linkage(mst: np.ndarray) -> np.ndarray:
    """Sorted spanning-tree edges -> rows (left, right, distance, size), a
    node made by row i numbered n + i."""
    n = len(mst) + 1
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.concatenate([np.ones(n, np.int64), np.zeros(n - 1, np.int64)])
    out = np.zeros((n - 1, 4))

    def find(v):
        root = v
        while parent[root] != -1:
            root = parent[root]
        while parent[v] != -1 and v != root:  # path compression
            parent[v], v = root, parent[v]
        return root

    for i, (a, b, dist) in enumerate(mst):
        ra, rb = find(int(a)), find(int(b))
        out[i] = (ra, rb, dist, size[ra] + size[rb])
        parent[ra] = parent[rb] = n + i
        size[n + i] = size[ra] + size[rb]
    return out


def _bfs(tree: np.ndarray, root: int) -> list:
    n = len(tree) + 1
    queue, result = [root], []
    while queue:
        result.extend(queue)
        queue = [int(c) for x in queue if x >= n for c in tree[x - n, :2]]
    return result


def _condense(tree: np.ndarray, min_cluster_size: int) -> list:
    """(parent, child, lambda, size) rows of the condensed tree."""
    n = len(tree) + 1
    root = 2 * (n - 1)
    relabel = np.empty(root + 1, np.int64)
    relabel[root] = n
    next_label = n + 1
    ignore = np.zeros(root + 1, bool)
    rows = []

    def count(node):
        return int(tree[node - n, 3]) if node >= n else 1

    for node in _bfs(tree, root):
        if ignore[node] or node < n:
            continue
        left, right, dist, _ = tree[node - n]
        left, right = int(left), int(right)
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lc, rc = count(left), count(right)
        if lc >= min_cluster_size and rc >= min_cluster_size:
            for child, c in ((left, lc), (right, rc)):
                relabel[child] = next_label
                next_label += 1
                rows.append((relabel[node], relabel[child], lam, c))
        else:
            drop = []
            if lc < min_cluster_size:
                drop.append(left)
            else:
                relabel[left] = relabel[node]
            if rc < min_cluster_size:
                drop.append(right)
            else:
                relabel[right] = relabel[node]
            for sub in drop:
                for leaf in _bfs(tree, sub):
                    if leaf < n:
                        rows.append((relabel[node], leaf, lam, 1))
                    ignore[leaf] = True
    return rows


def _select_eom(rows: list) -> tuple[set, int]:
    """Clusters chosen by excess of mass (never the root), and the root."""
    parents = np.array([r[0] for r in rows])
    children = np.array([r[1] for r in rows])
    lams = np.array([r[2] for r in rows])
    sizes = np.array([r[3] for r in rows])
    smallest = int(parents.min())
    births = np.full(max(int(children.max()), smallest) + 1, np.nan)
    births[children] = lams
    births[smallest] = 0.0
    stability = {c: 0.0 for c in range(smallest, int(parents.max()) + 1)}
    for p, lam, s in zip(parents, lams, sizes):
        stability[int(p)] += (lam - births[p]) * s
    node_list = sorted(stability, reverse=True)[:-1]
    is_cluster = {c: True for c in node_list}
    big = sizes > 1
    c_parents, c_children = parents[big], children[big]
    for node in node_list:
        sub = float(np.sum([stability[int(c)] for c in c_children[c_parents == node]]))
        if sub > stability[node]:
            is_cluster[node] = False
            stability[node] = sub
        else:
            queue = [node]
            while queue:
                for c in queue:
                    if c != node:
                        is_cluster[c] = False
                queue = [int(c) for c in c_children[np.isin(c_parents, queue)]]
    return {c for c, keep in is_cluster.items() if keep}, smallest


def hdbscan_labels(x: np.ndarray, min_cluster_size: int = 2) -> np.ndarray:
    """HDBSCAN cluster labels of the rows of x (Euclidean), noise -1,
    clusters numbered in the order of their condensed-tree ids."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n < 2:
        raise ValueError("HDBSCAN needs more than one sample")
    if min_cluster_size > n:
        raise ValueError(f"min_samples ({min_cluster_size}) must be at most {n}")
    d = _euclid(x[:, None, :], x[None, :, :])
    core = np.sort(d, axis=1)[:, min_cluster_size - 1]  # the point is its own neighbour
    mst = _mst_prim(x, core)
    tree = _single_linkage(mst[np.argsort(mst[:, 2])])
    rows = _condense(tree, min_cluster_size)
    clusters, root = _select_eom(rows)
    label_of = {c: i for i, c in enumerate(sorted(clusters))}
    # points joined to their parents along every edge into a non-cluster
    up = {}
    for p, c, _, _ in rows:
        if c not in clusters:
            up[int(c)] = int(p)
    labels = np.full(n, -1, np.intp)
    for i in range(n):
        node = i
        while node in up and node not in clusters:
            node = up[node]
        if node != root and node in label_of:
            labels[i] = label_of[node]
    return labels
