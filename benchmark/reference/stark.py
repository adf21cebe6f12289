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

The prover works on blocks of the domain, so that a trace of 2^27 rows
(an LDE of 2^30 points) fits one card: every layer (the LDE, the
composition, each FRI layer) is kept as its values' u32 words alone;
the LDE is `blowup` NTTs of the trace's size; the composition, the folds
and the trees' leaves are computed a block of lanes at a time; a tree
keeps only its levels from the roots of its 2^SUBTREE_LOG-leaf subtrees
up, and a path hashes its subtree again from the kept values.  The
block size changes no value: one block the size of the domain is the
whole-array computation.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from benchmark import airs

from .field import field_for, inverse, powers, root_of_unity, sum_lanes
from .sha256 import M32, hash_columns, to_int32

# Merkle levels of at most this many nodes are hashed on the host
HOST_LEVEL = 1 << 12
# the domain is worked in blocks of at most 2^BLOCK_LOG lanes: the host
# issues every torch op a block once, so the fewer blocks the less host
# time, and a block's SHA-256 message schedule holds 64 int64 words a lane
BLOCK_LOG = 25
# a tree keeps its levels from the roots of its 2^SUBTREE_LOG-leaf
# subtrees up
SUBTREE_LOG = 10
# a block hashes its own tree levels down to this many rows; the narrower
# levels are hashed for every block at once (a level's hashing costs
# its launches however few its lanes)
BLOCK_ROWS = 1 << 20


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
    butterflies of growing span, each span's twiddles a stride of one
    table of root's powers."""
    n = f.lanes(x)
    lead = tuple(x.shape[:-1])
    y = x[..., _bitrev(n, x.device)]
    table = powers(f, root, max(n // 2, 1), x.device)
    h = 1
    while h < n:
        tw = table[..., ::n // (2 * h)]
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


def _blocks(n: int, least: int = 1):
    """(start, size) of each block of n lanes (n a power of two): blocks
    of 2^BLOCK_LOG lanes, or of `least` where that is more, or one block
    of n where n is less."""
    size = min(n, max(1 << BLOCK_LOG, least))
    for s in range(0, n, size):
        yield s, size


def _load(words: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """Elements of lanes start .. start + size - 1 (cyclically) of a
    layer's u32 words ((n,), or (2, n) Goldilocks planes)."""
    n = int(words.shape[-1])
    start %= n
    if start + size <= n:
        w = words[..., start:start + size]
    else:
        w = torch.cat((words[..., start:], words[..., :start + size - n]),
                      dim=-1)
    return w.to(torch.int64) & M32


def _value(f, words: torch.Tensor, i: int) -> int:
    return f.to_ints(f.from_words(words[..., i:i + 1]))[0]


def lde(f, spec: Spec, column: torch.Tensor) -> torch.Tensor:
    """The column's interpolant of degree <= N - 2 on the coset, as u32
    words in natural order on the column's device.  The value at g^(N-1) is
    chosen so that the top coefficient vanishes (c_(N-1) = (sum_i v_i
    g^i) / N, so v_(N-1) = -g sum_(i<N-1) v_i g^i), then an INTT; the
    value at h w^(r + blowup j) is sum_k c_k (h w^r)^k g^(jk), so the
    positions of each residue r < blowup are one N-point NTT of the
    coefficients scaled by (h w^r)^k."""
    p, n, b = f.p, 1 << spec.log2_trace, spec.blowup
    dev = column.device
    g, w = root_of_unity(p, n), root_of_unity(p, n * b)
    s = sum_lanes(f, f.mul(column, powers(f, g, n, dev)[..., :n - 1]))
    last = f.from_ints([-g * s], dev)
    coeffs = intt(f, torch.cat((column, last), dim=-1), g)
    lead = tuple(coeffs.shape[:-1])
    out = torch.empty(lead + (n, b), dtype=torch.int32, device=dev)
    for r in range(b):
        scaled = f.mul(coeffs, powers(f, spec.offset * pow(w, r, p), n, dev))
        out[..., r] = to_int32(ntt(f, scaled, g))
    return out.view(lead + (n * b,))


def _words(layer: torch.Tensor) -> list:
    """A layer's values as (hi, lo) word columns for a leaf message."""
    if layer.dim() == 1:
        return [0, layer]
    return [layer[0], layer[1]]


def _parents(level: torch.Tensor) -> torch.Tensor:
    """The level above a level of device digest rows."""
    pairs = level.view(-1, 16).to(torch.int64) & M32
    return hash_columns([pairs[:, j] for j in range(16)], 64,
                        chunk=int(pairs.shape[0]))


class Tree:
    """A Merkle tree whose leaf i hashes lane i of the word columns `cols`
    (u32 words as (n,) int32 tensors, or a Python int shared by every
    leaf), 4 big-endian bytes a word.  The leaves are hashed a block at a
    time, each block's levels down to BLOCK_ROWS rows or
    its 2^SUBTREE_LOG-leaf subtrees' roots; the levels above are device
    levels (int32 digest rows) while a level has more than HOST_LEVEL
    nodes, then host levels (numpy uint32 rows) hashed with hashlib.  The
    tree keeps the levels from the subtrees' roots up; a path hashes its
    subtree again on the host, from the leaves' words."""

    def __init__(self, cols):
        self.cols = cols
        n = max(int(c.shape[0]) for c in cols if torch.is_tensor(c))
        self.base = min(n.bit_length() - 1, SUBTREE_LOG)
        kept = n.bit_length() - self.base  # levels from the roots up
        tops = []
        for s, size in _blocks(n, 1 << self.base):
            words = [c[s:s + size].to(torch.int64) & M32
                     if torch.is_tensor(c) else c for c in cols]
            level = hash_columns(words, 4 * len(cols), chunk=size)
            while int(level.shape[0]) > max(size >> self.base, BLOCK_ROWS):
                level = _parents(level)
            tops.append(level)
        level = torch.cat(tops)
        self.levels = []
        while True:
            n = int(level.shape[0])
            self.levels.append(level)
            del self.levels[:-kept]
            if n == 1:
                break
            if n // 2 <= HOST_LEVEL and torch.is_tensor(level):
                level = level.cpu().numpy().view(np.uint32)
                self.levels[-1] = level
            if torch.is_tensor(level):
                level = _parents(level)
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
        self._subtree = (None, None)

    def _lower(self, t: int) -> list:
        """Subtree t's levels below its root, leaves first (digests as
        bytes), hashed with hashlib from its leaves' words."""
        sub = 1 << self.base
        words = [c[t * sub:(t + 1) * sub].cpu().numpy().view(np.uint32)
                 if torch.is_tensor(c) else np.full(sub, c, np.uint32)
                 for c in self.cols]
        raw = np.stack(words, axis=1).astype(">u4").tobytes()
        size = 4 * len(self.cols)
        level = [hashlib.sha256(raw[i * size:(i + 1) * size]).digest()
                 for i in range(sub)]
        levels = []
        while len(level) > 1:
            levels.append(level)
            level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                     for i in range(0, len(level), 2)]
        return levels

    def path(self, j: int) -> bytes:
        """The siblings of leaf j from the leaves up, 32 bytes each."""
        t = j >> self.base
        if self._subtree[0] != t:
            self._subtree = (t, self._lower(t))
        local = j - (t << self.base)
        rows = [level[(local >> k) ^ 1]
                for k, level in enumerate(self._subtree[1])]
        for k, level in enumerate(self.levels[:-1]):
            row = level[(j >> (self.base + k)) ^ 1]
            if torch.is_tensor(row):
                row = row.cpu().numpy().view(np.uint32)
            rows.append(row.astype(">u4").tobytes())
        return b"".join(rows)


class Composition:
    """What an AIR's constraints (``terms`` of ``benchmark/airs/<air>.py``)
    are written with, on the block of lanes start .. start + size - 1 of
    the coset x = h w^i: the field `f`, the columns' LDE values `ldes`,
    the `publics`, ``c(v)`` a constant, ``shifted(col, k)`` column `col`
    at row + k, `inv_first` and `inv_last` 1 / (x - g^0) and
    1 / (x - g^(N-2)), and ``transition(k)`` the divisor of a constraint
    over k + 1 rows, (x^N - 1) / prod_(j <= k) (x - g^(N-1-j))
    inverted."""

    def __init__(self, f, spec: Spec, lde_words, publics, device,
                 start: int, size: int):
        p, n, b = f.p, 1 << spec.log2_trace, spec.blowup
        m = n * b
        self.f, self.publics = f, publics
        self._words, self._start, self._size = lde_words, start, size
        self._nd, self._dev = 1, device
        self._g, self._n, self._b = root_of_unity(p, n), n, b
        self.ldes = [self.shifted(col, 0) for col in range(len(lde_words))]
        c = self.c
        w = root_of_unity(p, m)
        self._x = f.mul(powers(f, w, size, device),
                        c(spec.offset * pow(w, start, p)))
        self.inv_first = inverse(f, f.sub(self._x, c(1)))
        self.inv_last = inverse(f, f.sub(self._x,
                                         c(pow(self._g, n - 2, p))))
        # x^N takes `blowup` values on the coset, h^N (w^N)^i
        hn, wn = pow(spec.offset, n, p), pow(w, n, p)
        zinv = f.from_ints([pow(hn * pow(wn, j, p) - 1, p - 2, p)
                            for j in range(b)], device)
        lanes = torch.arange(start, start + size, device=device) % b
        self._zinv = zinv[..., lanes]

    def c(self, v: int) -> torch.Tensor:
        return self.f.const(v, self._nd, self._dev)

    def shifted(self, col: int, k: int) -> torch.Tensor:
        return _load(self._words[col], self._start + k * self._b,
                     self._size)

    def transition(self, k: int) -> torch.Tensor:
        f, p, n = self.f, self.f.p, self._n
        out = None
        for j in range(k + 1):
            term = f.sub(self._x, self.c(pow(self._g, n - 1 - j, p)))
            out = term if out is None else f.mul(out, term)
        return f.mul(out, self._zinv)


def _composition(f, spec: Spec, lde_words, alphas, publics) -> torch.Tensor:
    """The AIR's composition on the coset, from the columns' LDE words:
    its constraint terms summed with the weights `alphas`, a block at a
    time; u32 words on the words' device."""
    d = lde_words[0].device
    out = torch.empty(lde_words[0].shape, dtype=torch.int32, device=d)
    for s, size in _blocks(int(out.shape[-1])):
        terms = spec.air_def.terms(Composition(f, spec, lde_words, publics,
                                               d, s, size))
        if len(terms) != len(alphas):
            raise ValueError(f"{spec.air}: {len(terms)} constraints, "
                             f"{len(alphas)} weights")
        acc = None
        for a, t in zip(alphas, terms):
            term = f.mul(t, f.const(a, 1, d))
            acc = term if acc is None else f.add(acc, term)
        out[..., s:s + size] = to_int32(acc)
    return out


def _fold(f, layer: torch.Tensor, beta: int, offset: int) -> torch.Tensor:
    """The next FRI layer of `layer` (u32 words), a block at a time."""
    p, half, d = f.p, int(layer.shape[-1]) // 2, layer.device
    w_inv = pow(root_of_unity(p, 2 * half), p - 2, p)
    out = torch.empty(layer.shape[:-1] + (half,), dtype=torch.int32,
                      device=d)
    for s, size in _blocks(half):
        inv_x = f.mul(powers(f, w_inv, size, d),
                      f.const(pow(offset, p - 2, p) * pow(w_inv, s, p), 1, d))
        v, u = _load(layer, s, size), _load(layer, half + s, size)
        two = f.const(pow(2, p - 2, p), 1, d)
        even = f.mul(f.add(v, u), two)
        odd = f.mul(f.mul(f.mul(f.sub(v, u), two), inv_x),
                    f.const(beta, 1, d))
        out[..., s:s + size] = to_int32(f.add(even, odd))
    return out


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
    cols = [c.to(device) if torch.is_tensor(c)
            else f.from_ints(c, device) for c in trace]
    publics = publics_of(spec, cols)
    ldes = [lde(f, spec, c) for c in cols]
    del cols
    trace_tree = Tree([w for col in ldes for w in _words(col)])
    ch = Transcript(p)
    ch.send(trace_tree.root_hex.encode())
    alphas = [ch.draw_element() for _ in range(spec.air_def.ALPHAS)]

    layers = [_composition(f, spec, ldes, alphas, publics)]
    trees = [Tree(_words(layers[0]))]
    ch.send(trees[0].root_hex.encode())
    off = spec.offset % p
    for _ in range(spec.log2_trace):
        beta = ch.draw_element()
        layers.append(_fold(f, layers[-1], beta, off))
        off = off * off % p
        trees.append(Tree(_words(layers[-1])))
        ch.send(trees[-1].root_hex.encode())
    last = f.to_ints(f.from_words(layers[-1]))
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
            size = int(layer.shape[-1])
            if size == 1:
                ch.send(_value(f, layer, 0).to_bytes(8, "big"))
            i = idx % size
            for j in (i, (i + size // 2) % size):
                ch.send(_value(f, layer, j).to_bytes(8, "big"))
                ch.send(tree.path(j))
    return ch.messages, publics
