"""The plain reference prover: the same STARK as the program under test,
written out from the protocol in plain torch and the standard library.

Protocol (STARK-101's, over a prime field, SHA-256 throughout):

* trace: T = N - 1 rows of the AIR's columns (``benchmark/airs/``:
  the recurrence, the publics and the constraints of each AIR);
* each column's interpolant of degree <= N - 2 over g^0 .. g^(N-2)
  (g of order N), evaluated on the coset h w^i, i < M = blowup * N (w of
  order M, h the configuration's offset): the LDE;
* trace commitment: a Merkle tree whose leaf i is SHA-256 of row i's
  values, 8 big-endian bytes each, nodes SHA-256(left || right), the
  root sent as its lowercase hex string;
* the composition: the AIR's constraints, each divided by its
  vanishing polynomial, summed with weights alpha drawn from the
  transcript, on the same coset;
* FRI: log2(N) folds, next[i] = (E[i] + E[i + m/2]) / 2 +
  beta (E[i] - E[i + m/2]) / (2 x_i), each layer committed as above
  before its beta is drawn; the last layer's first value is sent;
* queries: an index drawn (and shown) a query, the trace rows at each
  shift with their paths, then every FRI layer's value and sibling with
  theirs.

The transcript is the Fiat-Shamir channel of STARK-101's Rust port: the
state is a hex string, a send hashes state ++ hex(message), a draw
reduces the state modulo the range and hashes the state's own hex.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from benchmark import airs

from .field import field_for, inverse, powers, root_of_unity, sum_lanes
from .sha256 import M32, hash_columns

# Merkle levels of at most this many nodes are hashed on the host
HOST_LEVEL = 1 << 12


@dataclasses.dataclass(frozen=True)
class Spec:
    """What a proof is of: the AIR, the field and the sizes."""

    air: str  # a file pair of benchmark/airs/
    modulus: int
    offset: int
    log2_trace: int
    blowup: int
    num_queries: int

    @property
    def air_def(self):
        """The AIR's definition (``benchmark/airs/<air>.py``)."""
        return airs.load(self.air)

    @classmethod
    def from_config(cls, cfg: dict) -> "Spec":
        return cls(air=cfg["air"], modulus=int(cfg["modulus"]),
                   offset=int(cfg["coset_offset"]),
                   log2_trace=int(cfg["log2_trace"]),
                   blowup=int(cfg["blowup"]),
                   num_queries=int(cfg["num_queries"]))


class Transcript:
    """The prover's Fiat-Shamir channel."""

    def __init__(self, p: int):
        self.p = p
        self.state = ""
        self.messages: list[bytes] = []

    def send(self, msg: bytes) -> None:
        self.state = hashlib.sha256((self.state + msg.hex()).encode()
                                    ).hexdigest()
        self.messages.append(bytes(msg))

    def draw_int(self, lo: int, hi: int, show: bool) -> int:
        num = (int(self.state, 16) + lo) % (hi - lo + 1)
        self.state = hashlib.sha256(self.state.encode()).hexdigest()
        num &= (1 << 64) - 1
        if show:
            self.messages.append(num.to_bytes(8, "big"))
        return num

    def draw_element(self) -> int:
        v = self.draw_int(0, self.p - 1, False)
        self.messages.append(v.to_bytes(8, "big"))
        return v


def plain_trace(spec: Spec, witness: int) -> list[list[int]]:
    """The trace columns of the statement, by the AIR's recurrence over
    Python ints from the witness."""
    return spec.air_def.plain_trace(spec.modulus, witness,
                                    (1 << spec.log2_trace) - 1)


def columns_from_words(spec: Spec, words: torch.Tensor) -> list:
    """A trace's storage words (int64 tensor; (T,) or (2, T) a column,
    the columns first where there are several) -> element tensors of
    the reference field, one a column."""
    f = field_for(spec.modulus)
    if spec.air_def.COLUMNS == 1:
        words = words.unsqueeze(0)
    return [f.from_words(words[c]) for c in range(spec.air_def.COLUMNS)]


def _bitrev(n: int, device) -> torch.Tensor:
    log_n = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt(f, x: torch.Tensor, root: int) -> torch.Tensor:
    """X[k] = sum_j x[j] root^(jk) over the last axis (a power of two
    long), natural order in and out: a bit reversal, then radix-2
    butterflies of growing span."""
    n = f.lanes(x)
    lead = tuple(x.shape[:-1])
    y = x[..., _bitrev(n, x.device)]
    h = 1
    while h < n:
        tw = powers(f, pow(root, n // (2 * h), f.p), h, x.device)
        y = y.reshape(lead + (n // (2 * h), 2, h))
        u, v = y[..., 0, :], f.mul(y[..., 1, :], tw.unsqueeze(-2))
        y = torch.stack((f.add(u, v), f.sub(u, v)), dim=-2).reshape(lead
                                                                     + (n,))
        h *= 2
    return y


def intt(f, x: torch.Tensor, root: int) -> torch.Tensor:
    n = f.lanes(x)
    y = ntt(f, x, pow(root, f.p - 2, f.p))
    return f.mul(y, f.const(pow(n, f.p - 2, f.p), y.dim() - (f.limbs - 1),
                            x.device))


def lde(f, spec: Spec, column: torch.Tensor) -> torch.Tensor:
    """The column's interpolant of degree <= N - 2 on the coset: the
    value at g^(N-1) is chosen so that the top coefficient vanishes
    (c_(N-1) = (sum_i v_i g^i) / N, so v_(N-1) = -g sum_(i<N-1) v_i g^i),
    then an INTT, the coset scaling and an NTT of size M."""
    p, n = f.p, 1 << spec.log2_trace
    m = n * spec.blowup
    dev = column.device
    g, w = root_of_unity(p, n), root_of_unity(p, m)
    s = sum_lanes(f, f.mul(column, powers(f, g, n, dev)[..., :n - 1]))
    last = f.from_ints([-g * s], dev)
    coeffs = intt(f, torch.cat((column, last), dim=-1), g)
    coeffs = f.mul(coeffs, powers(f, spec.offset, n, dev))
    padded = torch.cat((coeffs, f.zeros(m - n, dev)), dim=-1)
    return ntt(f, padded, w)


def _words(f, column: torch.Tensor):
    """A column's values as (hi, lo) word columns for a leaf message."""
    if f.limbs == 1:
        return [0, column]
    return [column[0], column[1]]


class Tree:
    """A Merkle tree over n leaves: device levels (int32 digest rows)
    while a level has more than HOST_LEVEL nodes, then host levels
    (numpy uint32 rows) hashed with hashlib."""

    def __init__(self, leaf_words, nbytes: int):
        level = hash_columns(leaf_words, nbytes)
        self.levels = []
        while True:
            n = int(level.shape[0])
            self.levels.append(level)
            if n == 1:
                break
            if n // 2 <= HOST_LEVEL and torch.is_tensor(level):
                level = level.cpu().numpy().view(np.uint32)
                self.levels[-1] = level
            if torch.is_tensor(level):
                pairs = level.view(n // 2, 16).to(torch.int64) & M32
                level = hash_columns([pairs[:, j] for j in range(16)], 64)
            else:
                raw = level.astype(">u4").tobytes()
                level = np.frombuffer(b"".join(
                    hashlib.sha256(raw[64 * i:64 * i + 64]).digest()
                    for i in range(n // 2)), dtype=">u4").reshape(-1, 8
                                                                  ).astype(
                    np.uint32)
        root = self.levels[-1]
        if torch.is_tensor(root):
            root = root.cpu().numpy().view(np.uint32)
        self.root_hex = root.astype(">u4").tobytes().hex()

    def path(self, j: int) -> bytes:
        """The siblings of leaf j from the leaves up, 32 bytes each."""
        rows = []
        for lvl, level in enumerate(self.levels[:-1]):
            sib = (j >> lvl) ^ 1
            if torch.is_tensor(level):
                rows.append(level[sib])
            else:
                rows.append(torch.from_numpy(level[sib].view(np.int32)))
        dev = [r.cpu() for r in rows]
        return np.stack([r.numpy() for r in dev]).view(np.uint32).astype(
            ">u4").tobytes()


def _value(f, column: torch.Tensor, i: int) -> int:
    return f.to_ints(column[..., i:i + 1])[0]


class Composition:
    """What an AIR's constraints (``terms`` of ``benchmark/airs/<air>.py``)
    are written with, on the coset x = h w^i: the field `f`, the columns'
    LDEs `ldes`, the `publics`, ``c(v)`` a constant, ``shifted(col, k)``
    column `col` at row + k, `inv_first` and `inv_last` 1 / (x - g^0)
    and 1 / (x - g^(N-2)), and ``transition(k)`` the divisor of a
    constraint over k + 1 rows, (x^N - 1) / prod_(j <= k) (x - g^(N-1-j))
    inverted."""

    def __init__(self, f, spec: Spec, ldes, publics):
        p, n, b = f.p, 1 << spec.log2_trace, spec.blowup
        m, dev = n * b, ldes[0].device
        self.f, self.ldes, self.publics = f, ldes, publics
        self._nd, self._dev = ldes[0].dim() - (f.limbs - 1), dev
        self._g, self._n, self._b = root_of_unity(p, n), n, b
        c = self.c
        self._x = f.mul(powers(f, root_of_unity(p, m), m, dev),
                        c(spec.offset))
        self.inv_first = inverse(f, f.sub(self._x, c(1)))
        self.inv_last = inverse(f, f.sub(self._x,
                                         c(pow(self._g, n - 2, p))))
        # x^N takes `blowup` values on the coset, h^N (w^N)^i
        hn, wn = pow(spec.offset, n, p), pow(root_of_unity(p, m), n, p)
        zinv = f.from_ints([pow(hn * pow(wn, j, p) - 1, p - 2, p)
                            for j in range(b)], dev)
        self._zinv = zinv.repeat((1,) * (zinv.dim() - 1) + (m // b,))

    def c(self, v: int) -> torch.Tensor:
        return self.f.const(v, self._nd, self._dev)

    def shifted(self, col: int, k: int) -> torch.Tensor:
        return torch.roll(self.ldes[col], -k * self._b, dims=-1)

    def transition(self, k: int) -> torch.Tensor:
        f, p, n = self.f, self.f.p, self._n
        out = None
        for j in range(k + 1):
            term = f.sub(self._x, self.c(pow(self._g, n - 1 - j, p)))
            out = term if out is None else f.mul(out, term)
        return f.mul(out, self._zinv)


def _composition(f, spec: Spec, ldes, alphas, publics) -> torch.Tensor:
    """The AIR's composition on the coset, from the columns' LDEs: its
    constraint terms summed with the weights `alphas`."""
    terms = spec.air_def.terms(Composition(f, spec, ldes, publics))
    if len(terms) != len(alphas):
        raise ValueError(f"{spec.air}: {len(terms)} constraints, "
                         f"{len(alphas)} weights")
    acc = None
    for a, t in zip(alphas, terms):
        term = f.mul(t, f.const(a, ldes[0].dim() - (f.limbs - 1),
                                ldes[0].device))
        acc = term if acc is None else f.add(acc, term)
    return acc


def _fold(f, layer: torch.Tensor, beta: int, offset: int) -> torch.Tensor:
    p, m = f.p, f.lanes(layer)
    dev = layer.device
    nd = layer.dim() - (f.limbs - 1)
    w_inv = pow(root_of_unity(p, m), p - 2, p)
    inv_x = f.mul(powers(f, w_inv, m // 2, dev),
                  f.const(pow(offset, p - 2, p), nd, dev))
    v, s = layer[..., :m // 2], layer[..., m // 2:]
    half = f.const(pow(2, p - 2, p), nd, dev)
    even = f.mul(f.add(v, s), half)
    odd = f.mul(f.mul(f.mul(f.sub(v, s), half), inv_x),
                f.const(beta, nd, dev))
    return f.add(even, odd)


def publics_of(spec: Spec, trace) -> dict:
    """The public statement of a trace (columns of ints or element
    tensors)."""

    def at(c, i):
        col = trace[c]
        if torch.is_tensor(col):
            i %= int(col.shape[-1])
            return field_for(spec.modulus).to_ints(col[..., i:i + 1])[0]
        return int(col[i])

    return spec.air_def.publics(at)


def prove(spec: Spec, trace, device, num_queries: int | None = None):
    """The transcript (list of messages) and publics of the statement
    whose trace columns are `trace` (lists of ints, or element tensors
    of the reference field), computed on `device`.  `num_queries`
    overrides the configuration's (the control)."""
    f = field_for(spec.modulus)
    p, n, b = f.p, 1 << spec.log2_trace, spec.blowup
    m = n * b
    cols = [c.to(device) if torch.is_tensor(c) else f.from_ints(c, device)
            for c in trace]
    publics = publics_of(spec, cols)
    ldes = [lde(f, spec, c) for c in cols]
    del cols
    words = [w for col in ldes for w in _words(f, col)]
    trace_tree = Tree(words, 8 * len(ldes))
    ch = Transcript(p)
    ch.send(trace_tree.root_hex.encode())
    alphas = [ch.draw_element() for _ in range(spec.air_def.ALPHAS)]

    layers = [_composition(f, spec, ldes, alphas, publics)]
    trees = [Tree(_words(f, layers[0]), 8)]
    ch.send(trees[0].root_hex.encode())
    off = spec.offset % p
    for _ in range(spec.log2_trace):
        beta = ch.draw_element()
        layers.append(_fold(f, layers[-1], beta, off))
        off = off * off % p
        trees.append(Tree(_words(f, layers[-1]), 8))
        ch.send(trees[-1].root_hex.encode())
    last = f.to_ints(layers[-1])
    if any(v != last[0] for v in last):
        raise ValueError("the last FRI layer is not constant")
    ch.send(last[0].to_bytes(8, "big"))

    shifts = [s * b for s in spec.air_def.SHIFTS]
    for _ in range(spec.num_queries if num_queries is None else num_queries):
        idx = ch.draw_int(0, m - max(shifts) - 1, True)
        for s in shifts:
            ch.send(b"".join(_value(f, col, idx + s).to_bytes(8, "big")
                             for col in ldes))
            ch.send(trace_tree.path(idx + s))
        for layer, tree in zip(layers, trees):
            size = f.lanes(layer)
            if size == 1:
                ch.send(_value(f, layer, 0).to_bytes(8, "big"))
            i = idx % size
            for j in (i, (i + size // 2) % size):
                ch.send(_value(f, layer, j).to_bytes(8, "big"))
                ch.send(tree.path(j))
    return ch.messages, publics
