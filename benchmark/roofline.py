"""The least time the card could take for a prove's Merkle hashing and
its NTTs: the yardstick of ``merkle_roofline`` and ``ntt_roofline``.

Frozen from the program's chip checks (``chip_smoke.py`` at the time the
benchmark was written), so that the yardstick cannot move with the
program:

* the rates: HBM3 at 3.35e12 B/s (the H100 SXM data sheet) and a 32-bit
  integer peak that is DERIVED, not published: SMs x 128 lanes a clock
  x the card's maximum SM clock (132 x 128 x 1980 MHz = 3.3454e13 op/s
  on an H100 SXM), read from the card in each run;
* a SHA-256 compression 64 rounds of 14 operations, 48 schedule words
  of 10, 8 final adds; a node (64-byte message) one compression plus a
  padding block whose schedule is constant (2288); a leaf counted with
  its constant message words folded (:func:`sha_leaf_ops`);
* an NTT of n values n/2 log2(n) butterflies of 10 operations (a
  Montgomery product 6, an add and a subtract mod p 2 each), plus per
  value the conversions to and from Montgomery form and the twiddle
  product (6 + 6 + 4), and n^-1 (6) for an inverse; n words read and n
  written.

A bound is the larger of the bytes over the HBM rate and the operations
over the integer rate.  The work is what the inputs need, whatever code
does it: every leaf and node of the trace tree and of every FRI layer's
tree hashed once, the trace INTT and the coset NTT once.
"""

from __future__ import annotations

from benchmark import airs

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_SM_CLOCK = 128

SHA_ROUND_OPS, SHA_SCHED_OPS = 14, 10
SHA_OPS = 64 * SHA_ROUND_OPS + 48 * SHA_SCHED_OPS + 8
SHA_PAD_OPS = 64 * SHA_ROUND_OPS + 8
NODE_OPS = SHA_OPS + SHA_PAD_OPS
MONT_OPS, ADDSUB_OPS, FROM_MONT_OPS = 6, 2, 4

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F,
      0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

# a tree stores only its levels of at most 2^PRUNE_KEEP_LOG nodes (the
# program's pruned storage when the benchmark was written): the bytes a
# build must write
PRUNE_KEEP_LOG = 22


def sha_leaf_ops(c: int, wide: bool) -> int:
    """The operations of one leaf of c values (8 bytes each; `wide`: both
    32-bit words depend on the value, else the high word is 0) once its
    constant message words are folded: SHA_OPS's count with every Sigma,
    sigma, Ch, Maj and add of constant inputs left out, an add of n
    data-dependent terms and a nonzero constant costing n // 2 3-input
    adds."""
    data, mask = None, 0xFFFFFFFF

    def rotr(x, n):
        return (x >> n | x << 32 - n) & mask

    def op(cost, f, *args):
        if any(a is data for a in args):
            return data, cost
        return f(*args) & mask, 0

    def add(*terms):
        n = sum(t is data for t in terms)
        k = sum(t for t in terms if t is not data) & mask
        return (k, 0) if n == 0 else (data, (n + (k != 0)) // 2)

    def big_sigma(*r):
        return lambda x: rotr(x, r[0]) ^ rotr(x, r[1]) ^ rotr(x, r[2])

    def small_sigma(r1, r2, s):
        return lambda x: rotr(x, r1) ^ rotr(x, r2) ^ x >> s

    w = [0] * 16
    for k in range(c):
        if wide:
            w[2 * k] = data
        w[2 * k + 1] = data
    w[2 * c], w[15] = 0x80000000, 64 * c
    ops = 0
    for t in range(16, 64):
        s1, o1 = op(4, small_sigma(17, 19, 10), w[t - 2])
        s0, o2 = op(4, small_sigma(7, 18, 3), w[t - 15])
        word, o3 = add(s1, w[t - 7], s0, w[t - 16])
        w.append(word)
        ops += o1 + o2 + o3
    a, b, cc, d, e, f, g, h = H0
    for t in range(64):
        s1, o1 = op(4, big_sigma(6, 11, 25), e)
        ch, o2 = op(1, lambda x, y, z: x & y ^ ~x & z, e, f, g)
        t1, o3 = add(h, s1, ch, K[t], w[t])
        s0, o4 = op(4, big_sigma(2, 13, 22), a)
        maj, o5 = op(1, lambda x, y, z: x & y ^ x & z ^ y & z, a, b, cc)
        new_a, o6 = add(t1, s0, maj)
        new_e, o7 = add(d, t1)
        ops += o1 + o2 + o3 + o4 + o5 + o6 + o7
        a, b, cc, d, e, f, g, h = new_a, a, b, cc, new_e, e, f, g
    return ops + sum(add(x, iv)[1] for x, iv in zip(
        (a, b, cc, d, e, f, g, h), H0))


class Card:
    """The rates of the card a run measured on: `sms` multiprocessors at
    a maximum SM clock of `clock_mhz`."""

    def __init__(self, sms: int, clock_mhz: float):
        self.sms, self.clock_mhz = sms, clock_mhz
        self.int32_ops_per_s = sms * INT32_OPS_PER_SM_CLOCK * clock_mhz * 1e6

    def bound(self, nbytes: float, ops: float) -> float:
        """Least seconds for this work."""
        return max(nbytes / HBM_BYTES_PER_S, ops / self.int32_ops_per_s)

    def ntt_bound(self, n: int, inverse: bool) -> float:
        log_n = n.bit_length() - 1
        butterfly = MONT_OPS + 2 * ADDSUB_OPS
        ops = (butterfly * (n // 2) * log_n
               + n * (2 * MONT_OPS + FROM_MONT_OPS + MONT_OPS * inverse))
        return self.bound(8 * n, ops)


def _stored_rows(n: int) -> int:
    """Digest rows a tree of n (a power of two) leaves stores."""
    prune = max(0, n.bit_length() - 1 - PRUNE_KEEP_LOG)
    return 2 * (n >> prune) - 1


def tree_work(n: int, columns: int, wide: bool) -> tuple[float, float]:
    """(bytes, operations) of one tree of n leaves of `columns` values:
    the values read once, the stored digest rows written once, every
    leaf and node hashed once."""
    nbytes = 4 * (2 if wide else 1) * columns * n + 32 * _stored_rows(n)
    return nbytes, sha_leaf_ops(columns, wide) * n + NODE_OPS * (n - 1)


def prove_trees(spec) -> list[tuple[int, int, bool]]:
    """(leaves, columns, wide) of every tree of one prove: the trace
    tree over the LDE's rows, then the FRI layers' trees."""
    wide = spec["modulus"] >= 1 << 32
    m = spec["blowup"] << spec["log2_trace"]
    cols = airs.load(spec["air"]).COLUMNS
    return [(m, cols, wide)] + [(m >> k, 1, wide)
                                for k in range(spec["log2_trace"] + 1)]


def merkle_least_s(spec, card: Card) -> float:
    """Least seconds for all of one prove's Merkle hashing: the trees'
    bytes and operations together."""
    nbytes = ops = 0.0
    for n, c, wide in prove_trees(spec):
        b, o = tree_work(n, c, wide)
        nbytes += b
        ops += o
    return card.bound(nbytes, ops)


def ntt_least_s(spec, card: Card) -> float:
    """Least seconds for one prove's NTTs on a u32 field: the INTT of
    each trace column (N values) and its coset NTT (M values)."""
    n = 1 << spec["log2_trace"]
    cols = airs.load(spec["air"]).COLUMNS
    return cols * (card.ntt_bound(n, True)
                   + card.ntt_bound(n * spec["blowup"], False))
