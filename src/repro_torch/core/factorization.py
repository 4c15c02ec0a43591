"""Flexible Factorization (paper Alg. 1) + FlexScore.

Shrinks the prime-factor pool of each loop bound by greedily merging factor
pairs while the relative loss of mapping flexibility stays below ``alpha``,
stopping at ``k_min`` factors. FlexScore counts the unique ways the factor
multiset can be partitioned into k ∈ {1,2,3} disjoint non-empty subsets
(identified by their sorted product tuples), weighted by decreasing
``mu_p``.
"""

from __future__ import annotations

import functools
import math
from collections import Counter

DEFAULT_MU_P = (1.0, 0.5, 0.25)
DEFAULT_ALPHA = 0.15
DEFAULT_KMIN = 3


def prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        out.append(n)
    return out


def _splits_2(ms: tuple[int, ...]) -> set[tuple[int, int]]:
    """Unique (a, b) with a<=b, a*b=prod(ms), both from non-empty disjoint
    sub-multisets. Enumerates achievable sub-multiset products."""
    total = math.prod(ms)
    prods = {1: Counter()}  # achievable product -> one witness sub-multiset
    achievable = {1}
    for f in ms:
        achievable |= {p * f for p in achievable}
    out = set()
    for a in achievable:
        if a == 1 or a == total:
            continue
        b = total // a
        if a * b == total:
            out.add((min(a, b), max(a, b)))
    # NOTE: for a multiset, every achievable product's complement is also
    # achievable (complement sub-multiset), so the check above is exact.
    return out


@functools.lru_cache(maxsize=65536)
def _sub_products(ms: tuple[int, ...]) -> frozenset[int]:
    """All products of (possibly empty) sub-multisets of ms."""
    acc = {1}
    for f in ms:
        acc |= {p * f for p in acc}
    return frozenset(acc)


@functools.lru_cache(maxsize=65536)
def _splits_3(ms: tuple[int, ...]) -> frozenset[tuple[int, int, int]]:
    """Unique sorted triples (a,b,c), a*b*c = prod(ms), from a partition of
    ms into three non-empty disjoint sub-multisets."""
    if len(ms) < 3:
        return frozenset()
    out = set()

    def rec(remaining: tuple[int, ...], chosen_prod: int, start_allowed: bool):
        pass

    # Enumerate first subset by distinct sub-multisets (via counts), then
    # 2-way split the remainder. Dedupe on product triples keeps this small.
    counts = Counter(ms)
    keys = sorted(counts)

    def gen_subsets(idx: int, cur: list[tuple[int, int]]):
        if idx == len(keys):
            take = Counter({k: c for k, c in cur if c})
            if sum(take.values()) == 0 or sum(take.values()) == len(ms):
                return
            a = math.prod(k ** c for k, c in take.items())
            rem = counts - take
            rem_tuple = tuple(sorted(rem.elements()))
            for b, c in _splits_2(rem_tuple):
                out.add(tuple(sorted((a, b, c))))
            return
        k = keys[idx]
        for c in range(counts[k] + 1):
            gen_subsets(idx + 1, cur + [(k, c)])

    gen_subsets(0, [])
    return frozenset(out)


@functools.lru_cache(maxsize=65536)
def flex_score(ms: tuple[int, ...],
               mu_p: tuple[float, float, float] = DEFAULT_MU_P) -> float:
    """Paper Alg. 1 FlexScore: weighted count of unique k-partitions."""
    ms = tuple(sorted(ms))
    p1 = 1 if ms else 0
    p2 = len(_splits_2(ms)) if len(ms) >= 2 else 0
    p3 = len(_splits_3(ms)) if len(ms) >= 3 else 0
    return mu_p[0] * p1 + mu_p[1] * p2 + mu_p[2] * p3


def flexible_factorization(
    n: int,
    alpha: float = DEFAULT_ALPHA,
    k_min: int = DEFAULT_KMIN,
    mu_p: tuple[float, float, float] = DEFAULT_MU_P,
) -> list[int]:
    """Paper Alg. 1, verbatim control flow.

    Returns a factor list F with prod(F) == n, len(F) >= 1 (empty for n=1).
    """
    if n <= 1:
        return []
    f = sorted(prime_factors(n))
    if len(f) <= k_min:
        return f
    score_full = flex_score(tuple(f), mu_p)
    while len(f) > k_min:
        score_base = flex_score(tuple(f), mu_p)
        best_delta, best_f = math.inf, None
        seen_pairs = set()
        for i in range(len(f)):
            for j in range(i + 1, len(f)):
                pair = (f[i], f[j])
                if pair in seen_pairs:
                    continue
                seen_pairs.add(pair)
                merged = sorted(f[:i] + f[i + 1:j] + f[j + 1:] + [f[i] * f[j]])
                score_m = flex_score(tuple(merged), mu_p)
                delta = (score_base - score_m) / max(score_full, 1e-12)
                if delta < best_delta:
                    best_delta, best_f = delta, merged
        if best_delta > alpha:
            break
        f = best_f
    return f


def factorize_layer_dims(bounds: dict[str, int], alpha: float = DEFAULT_ALPHA,
                         k_min: int = DEFAULT_KMIN) -> dict[str, list[int]]:
    """Factor pools per canonical dim; dims with bound 1 get no factors."""
    return {d: flexible_factorization(b, alpha, k_min)
            for d, b in bounds.items() if b > 1}


def sub_multiset_products(factors: list[int]) -> list[int]:
    """Sorted achievable tile bounds for a dim (used by size enumeration)."""
    return sorted(_sub_products(tuple(sorted(factors))))
