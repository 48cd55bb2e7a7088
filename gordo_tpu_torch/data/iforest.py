"""
An isolation forest in numpy (the port of the scikit-learn
``IsolationForest`` that ``gordo_tpu.data.filter_periods`` fits), for
the one configuration the period filter uses: ``max_features=1.0``,
``bootstrap=False`` and an integer ``random_state``, with any
``n_estimators``, ``max_samples`` and ``contamination``.

It draws what scikit-learn 1.9 draws, in the same order, so the trees
are scikit-learn's node for node:

- ``X`` is cast to float32. A ``RandomState(random_state)`` draws the
  trees' dummy targets, ``uniform(size=n)`` (they only decide whether a
  node is pure); a second one draws a seed a tree,
  ``randint(2**31 - 1, size=n_estimators)``.
- Tree ``i``'s rows come from ``RandomState(seed_i)`` through
  scikit-learn's ``sample_without_replacement`` (its ``auto`` choice of
  tracking selection, a permutation or reservoir sampling; all rows
  draw nothing). The tree's own seed is ``RandomState(seed_i).randint(
  2**31 - 1)``, and its splitter's xorshift state
  ``RandomState(tree seed).randint(0, 2**31 - 1)``.
- A tree grows depth first, left child first, to ``ceil(log2(
  max_samples))`` levels. A node of fewer than two rows, at the depth
  limit, or whose targets' variance is at most a float64 epsilon is a
  leaf. Otherwise the random splitter draws features (a Fisher-Yates
  over the features not yet known to be constant below this node) until
  one is not constant over the node's rows (max - min above 1e-7 in
  float32), then a threshold ``uniform(min, max)`` from the xorshift
  state (a threshold equal to max becomes min); rows at or below it go
  left.

Scoring walks every row down each tree at once (one vectorised step a
level), and ``score_samples``, ``offset_`` (the ``contamination``
percentile of the training scores), ``decision_function`` and
``predict`` are scikit-learn's formulas in the same order of float64
operations.
"""

from typing import List

import numpy as np

#: scikit-learn's ``MAX_INT`` and ``RAND_R_MAX`` (2**31 - 1)
MAX_INT = np.iinfo(np.int32).max
#: a feature whose node range is at most this (float32) is constant
FEATURE_THRESHOLD = np.float32(1e-7)
#: a node whose targets' variance is at most this is pure
EPSILON = np.finfo("double").eps
_UINT32 = 0xFFFFFFFF


def sample_without_replacement(n_population: int, n_samples: int, rng: np.random.RandomState):
    """scikit-learn's ``sample_without_replacement(method="auto")``."""
    ratio = n_samples / n_population if n_population != 0 else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    if ratio < 0.2:  # tracking selection
        selected, out = set(), []
        for _ in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out.append(j)
        return np.asarray(out, dtype=np.intp)
    out = np.arange(n_samples)  # reservoir sampling
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


def average_path_length(n_samples_leaf) -> np.ndarray:
    """The average path length of an unsuccessful search in a binary
    tree of ``n`` nodes (scikit-learn's ``_average_path_length``)."""
    n = np.asarray(n_samples_leaf, dtype=np.float64)
    shape = n.shape
    n = n.reshape((1, -1))
    out = np.zeros(n.shape)
    mask_1 = n <= 1
    mask_2 = n == 2
    other = ~np.logical_or(mask_1, mask_2)
    out[mask_1] = 0.0
    out[mask_2] = 1.0
    out[other] = 2.0 * (np.log(n[other] - 1.0) + np.euler_gamma) - 2.0 * (n[other] - 1.0) / n[other]
    return out.reshape(shape)


class _Xorshift:
    """scikit-learn's ``our_rand_r`` state and its two draws."""

    def __init__(self, seed: int):
        self.state = int(seed) & _UINT32

    def next(self) -> int:
        s = self.state or 1
        s ^= (s << 13) & _UINT32
        s ^= s >> 17
        s ^= (s << 5) & _UINT32
        self.state = s
        return s % (MAX_INT + 1)

    def rand_int(self, low: int, high: int) -> int:
        return low + self.next() % (high - low)

    def rand_uniform(self, low: float, high: float) -> float:
        return ((high - low) * float(self.next()) / float(MAX_INT)) + low


class IsolationTree:
    """One tree's arrays, as scikit-learn's ``tree_`` names them."""

    def __init__(self, X: np.ndarray, y: np.ndarray, rows: np.ndarray, seed: int, max_depth: int):
        n_features = X.shape[1]
        rand = _Xorshift(np.random.RandomState(seed).randint(0, MAX_INT))
        features = list(range(n_features))
        constant_features = [0] * n_features
        left: List[int] = []
        right: List[int] = []
        feature: List[int] = []
        threshold: List[float] = []
        n_node_samples: List[int] = []
        # (rows, depth, parent, is_left, n_constant_features)
        stack = [(rows, 0, -1, False, 0)]
        while stack:
            node_rows, depth, parent, is_left, n_known = stack.pop()
            n = len(node_rows)
            node_id = len(left)
            if parent >= 0:
                (left if is_left else right)[parent] = node_id
            left.append(-1)
            right.append(-1)
            feature.append(-2)
            threshold.append(-2.0)
            n_node_samples.append(n)
            if depth >= max_depth or n < 2 or self._impurity(y[node_rows]) <= EPSILON:
                continue
            split = self._split(X, node_rows, rand, features, constant_features, n_known)
            if split is None:
                continue
            f, t, go_left, n_total = split
            feature[node_id], threshold[node_id] = f, t
            stack.append((node_rows[~go_left], depth + 1, node_id, False, n_total))
            stack.append((node_rows[go_left], depth + 1, node_id, True, n_total))
        self.children_left = np.asarray(left, dtype=np.intp)
        self.children_right = np.asarray(right, dtype=np.intp)
        self.feature = np.asarray(feature, dtype=np.intp)
        self.threshold = np.asarray(threshold, dtype=np.float64)
        self.n_node_samples = np.asarray(n_node_samples, dtype=np.intp)
        self.node_count = len(left)
        self.max_depth = max_depth

    @staticmethod
    def _impurity(y: np.ndarray) -> float:
        """The squared-error criterion of unit-weight targets."""
        w = float(len(y))
        return float(np.dot(y, y)) / w - (float(y.sum()) / w) ** 2.0

    @staticmethod
    def _split(X, node_rows, rand: _Xorshift, features, constant_features, n_known):
        """scikit-learn's random splitter with ``max_features=1``:
        (feature, threshold, rows going left, constant features known
        below), or None when every feature is constant over the node."""
        n_features = len(features)
        f_i = n_features
        n_found = n_drawn = n_visited = 0
        n_total = n_known
        best = None
        while f_i > n_total and (n_visited < 1 or n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = rand.rand_int(n_drawn, f_i - n_found)
            if f_j < n_known:
                features[n_drawn], features[f_j] = features[f_j], features[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            current = features[f_j]
            values = X[node_rows, current]
            low, high = values.min(), values.max()
            if high <= low + FEATURE_THRESHOLD:
                features[f_j], features[n_total] = features[n_total], current
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            features[f_i], features[f_j] = features[f_j], features[f_i]
            t = rand.rand_uniform(float(low), float(high))
            if t == float(high):
                t = float(low)
            best = (current, t, values <= t)
        features[:n_known] = constant_features[:n_known]
        constant_features[n_known : n_known + n_found] = features[n_known : n_known + n_found]
        if best is None:
            return None
        return best + (n_total,)

    def apply(self, X: np.ndarray) -> np.ndarray:
        """Each row's leaf, every row one level a step."""
        node = np.zeros(len(X), dtype=np.intp)
        rows = np.arange(len(X))
        for _ in range(self.max_depth):
            inner = self.children_left[node] != -1
            if not inner.any():
                break
            go_left = X[rows, np.maximum(self.feature[node], 0)] <= self.threshold[node]
            node = np.where(inner, np.where(go_left, self.children_left[node],
                                            self.children_right[node]), node)
        return node

    def compute_node_depths(self) -> np.ndarray:
        depths = np.empty(self.node_count, dtype=np.int64)
        depths[0] = 1
        for node_id in range(self.node_count):
            if self.children_left[node_id] != -1:
                depths[self.children_left[node_id]] = depths[node_id] + 1
                depths[self.children_right[node_id]] = depths[node_id] + 1
        return depths


class IsolationForest:
    """scikit-learn's ``IsolationForest(n_estimators, max_samples,
    contamination, max_features=1.0, bootstrap=False, random_state)``
    (module docstring); ``max_samples`` is an int or ``"auto"``."""

    def __init__(self, n_estimators: int = 100, max_samples="auto", contamination=0.1,
                 random_state: int = 0):
        self.n_estimators = int(n_estimators)
        self.max_samples = max_samples
        self.contamination = contamination
        self.random_state = int(random_state)

    @staticmethod
    def _as_float32(X) -> np.ndarray:
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"Expected a 2-D array, got shape {X.shape}")
        if np.isnan(X).any():
            raise ValueError("The isolation forest takes no missing values")
        return X

    def fit(self, X) -> "IsolationForest":
        X = self._as_float32(X)
        n_samples = X.shape[0]
        y = np.random.RandomState(self.random_state).uniform(size=n_samples)
        if self.max_samples == "auto":
            max_samples = min(256, n_samples)
        else:
            max_samples = min(int(self.max_samples), n_samples)
        self.max_samples_ = max_samples
        max_depth = int(np.ceil(np.log2(max(max_samples, 2))))
        seeds = np.random.RandomState(self.random_state).randint(MAX_INT, size=self.n_estimators)
        self.estimators_ = []
        for seed in seeds:
            rng = np.random.RandomState(seed)
            sample_without_replacement(X.shape[1], X.shape[1], rng)  # the features: all
            drawn = sample_without_replacement(n_samples, max_samples, rng)
            rows = np.flatnonzero(np.bincount(drawn, minlength=n_samples))
            tree_seed = np.random.RandomState(seed).randint(MAX_INT)
            self.estimators_.append(IsolationTree(X, y, rows, tree_seed, max_depth))
        self._average_path_length_per_tree = [
            average_path_length(tree.n_node_samples) for tree in self.estimators_
        ]
        self._decision_path_lengths = [tree.compute_node_depths() for tree in self.estimators_]
        if self.contamination == "auto":
            self.offset_ = -0.5
        else:
            self.offset_ = np.percentile(self._score_samples(X), 100.0 * self.contamination)
        return self

    def _score_samples(self, X: np.ndarray) -> np.ndarray:
        depths = np.zeros(X.shape[0])
        X64 = X.astype(np.float64)
        for tree, path_lengths, average in zip(
            self.estimators_, self._decision_path_lengths, self._average_path_length_per_tree
        ):
            leaves = tree.apply(X64)
            depths += path_lengths[leaves] + average[leaves] - 1.0
        denominator = len(self.estimators_) * average_path_length([self.max_samples_])
        scores = 2 ** (-np.divide(depths, denominator, out=np.ones_like(depths),
                                  where=denominator != 0))
        return -scores

    def score_samples(self, X) -> np.ndarray:
        return self._score_samples(self._as_float32(X))

    def decision_function(self, X) -> np.ndarray:
        return self.score_samples(X) - self.offset_

    def predict(self, X) -> np.ndarray:
        decision = self.decision_function(X)
        is_inlier = np.ones_like(decision, dtype=int)
        is_inlier[decision < 0] = -1
        return is_inlier


def ewm_mean(values: np.ndarray, halflife: float) -> np.ndarray:
    """pandas' ``DataFrame.ewm(halflife=...).mean()`` (``adjust=True``,
    NaN-free columns), column by column, in pandas' order of float64
    operations."""
    values = np.asarray(values, dtype=np.float64)
    decay = 1 - np.exp(np.log(0.5) / halflife)
    com = 1 / decay - 1
    alpha = 1.0 / (1.0 + com)
    old_wt_factor = 1.0 - alpha
    out = np.empty_like(values)
    if not len(values):
        return out
    weighted = values[0].copy()
    out[0] = weighted
    old_wt = 1.0
    for i in range(1, len(values)):
        cur = values[i]
        old_wt *= old_wt_factor
        changed = weighted != cur
        weighted = np.where(changed, (old_wt * weighted + cur) / (old_wt + 1.0), weighted)
        old_wt += 1.0
        out[i] = weighted
    return out


