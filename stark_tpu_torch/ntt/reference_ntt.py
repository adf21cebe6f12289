# Copied from stark_tpu/ntt/reference_ntt.py (host-only), with its stark_tpu imports
# rewritten to the port: the port must not import stark_tpu, whose
# package init imports JAX.
"""Host-side NTT (numpy u64) — oracle for the device NTT and backend for
fast host polynomial multiplication.

Same Stockham-autosort dataflow as the device kernel (stark_tpu_torch.ntt.ntt) so
the two implementations cross-check each other stage by stage.  Fills the
reference's own TODO ("fft (ntt after fri is done)", Readme.md:2) — the
reference has no NTT at all.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _two_adicity(p: int) -> int:
    t, m = 0, p - 1
    while m % 2 == 0:
        t += 1
        m //= 2
    return t


def ntt_available(p: int, n: int) -> bool:
    """True if GF(p) has primitive n-th roots of unity (n a power of 2)."""
    if n & (n - 1):
        return False
    return n <= 1 << _two_adicity(p)


@functools.lru_cache(maxsize=None)
def _find_generator(p: int) -> int:
    """Smallest multiplicative generator of GF(p)^* (host, cached)."""
    factors = []
    m = p - 1
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in factors):
            return g
    raise ValueError(f"no generator found for {p} (not prime?)")


def root_of_unity(p: int, n: int) -> int:
    if not ntt_available(p, n):
        raise ValueError(f"GF({p}) has no order-{n} subgroup")
    return pow(_find_generator(p), (p - 1) // n, p)


@functools.lru_cache(maxsize=256)
def _twiddles(p: int, wl: int, count: int) -> np.ndarray:
    """[wl^j for j < count] via numpy doubling (cached; a Python pow loop
    here made host NTTs of composed polynomials seconds-slow)."""
    out = np.ones(1, dtype=np.uint64)
    cur = wl % p
    while len(out) < count:
        out = np.concatenate([out, (out * np.uint64(cur)) % np.uint64(p)])
        cur = cur * cur % p
    return out[:count]


def ntt_host(values, p: int, inverse: bool = False) -> np.ndarray:
    """Radix-2 Stockham NTT over GF(p), natural order in and out.

    Forward computes X[k] = sum_j x[j] w^(jk) with w a primitive n-th root;
    inverse uses w^-1 and scales by n^-1.
    """
    x = np.asarray(values, dtype=np.uint64) % np.uint64(p)
    n = len(x)
    if n == 1:
        return x.copy()
    if not ntt_available(p, n):
        raise ValueError(f"GF({p}) has no order-{n} subgroup")
    w = root_of_unity(p, n)
    if inverse:
        w = pow(w, p - 2, p)
    pp = np.uint64(p)
    l, m = n, 1
    while l > 1:
        lh = l // 2
        wl = pow(w, n // l, p)  # primitive l-th root
        tw = np.array([pow(wl, j, p) for j in range(lh)], dtype=np.uint64)
        v = x.reshape(l, m)
        a, b = v[:lh], v[lh:]
        top = (a + b) % pp
        bot = (tw[:, None] * ((a + pp - b) % pp)) % pp
        x = np.stack([top, bot], axis=1).reshape(n)
        l, m = lh, m * 2
    if inverse:
        ninv = np.uint64(pow(n, p - 2, p))
        x = (x * ninv) % pp
    return x


def ntt_mul_host(a, b, p: int, n: int) -> list[int]:
    """Polynomial product via NTT of size n >= len(a)+len(b)-1."""
    fa = np.zeros(n, dtype=np.uint64)
    fb = np.zeros(n, dtype=np.uint64)
    fa[: len(a)] = np.asarray(a, dtype=np.uint64)
    fb[: len(b)] = np.asarray(b, dtype=np.uint64)
    ta = ntt_host(fa, p)
    tb = ntt_host(fb, p)
    prod = (ta * tb) % np.uint64(p)
    out = ntt_host(prod, p, inverse=True)
    return out[: len(a) + len(b) - 1].astype(object).tolist()


def naive_dft(values, p: int, inverse: bool = False):
    """O(n^2) DFT — the oracle's oracle for tiny n."""
    vals = [int(v) % p for v in values]
    n = len(vals)
    w = root_of_unity(p, n)
    if inverse:
        w = pow(w, p - 2, p)
    out = []
    for k in range(n):
        acc = 0
        for j, v in enumerate(vals):
            acc = (acc + v * pow(w, j * k % n, p)) % p
        out.append(acc)
    if inverse:
        ninv = pow(n, p - 2, p)
        out = [v * ninv % p for v in out]
    return out
