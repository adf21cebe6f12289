"""Prime-field arithmetic on plain torch int64 tensors, for the plain
reference prover.

Two fields:

* :class:`U32Field`, a prime below 2^32 (STARK-101's 3 * 2^30 + 1): an
  element is an int64 tensor of canonical values.  A product of two
  values would pass 2^63, so one factor is split in 16-bit halves.
* :class:`GoldilocksField`, p = 2^64 - 2^32 + 1: an element is an int64
  tensor whose first axis holds the (hi, lo) 32-bit halves.  With
  phi = 2^32, phi^2 = phi - 1 and phi^3 = -1 (mod p), so a product
  folds to two base-phi digits, which :meth:`GoldilocksField.canon`
  carries back into [0, p).

Nothing here is shared with the program under test: the formulas are
the textbook ones, written out for tensors.

Values from the host (constants, short lists) are copied to the device
without waiting for it (``_to``), so that the host keeps queueing work
ahead of the device.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _to(data, device) -> torch.Tensor:
    """An int64 tensor of `data` on `device` (the host where None), copied
    without a synchronisation: a copy from the host's pageable memory is
    staged before the call returns."""
    return torch.tensor(data, dtype=torch.int64).to(device,
                                                    non_blocking=True)


def smallest_generator(p: int) -> int:
    """The smallest generator of GF(p)^* (p prime)."""
    factors, m, d = [], p - 1, 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    g = 2
    while any(pow(g, (p - 1) // q, p) == 1 for q in factors):
        g += 1
    return g


def root_of_unity(p: int, n: int) -> int:
    """The order-n root g^((p - 1) / n), g the smallest generator."""
    if (p - 1) % n:
        raise ValueError(f"GF({p}) has no subgroup of order {n}")
    return pow(smallest_generator(p), (p - 1) // n, p)


class _Field:
    """What both fields share: storage words to elements, and the lane
    count of an element tensor (its last axis)."""

    @staticmethod
    def from_words(words: torch.Tensor) -> torch.Tensor:
        """Storage words (u32 bits as int32, or int64 values; Goldilocks:
        the (hi, lo) planes on the first axis) -> elements."""
        return words.to(torch.int64) & M32

    @staticmethod
    def lanes(x) -> int:
        return int(x.shape[-1])


class U32Field(_Field):
    """GF(p) for an odd prime p < 2^32; elements are int64 tensors."""

    limbs = 1

    def __init__(self, p: int):
        if not 2 < p < 1 << 32:
            raise ValueError(f"{p} is not a prime below 2^32")
        self.p = p

    def const(self, v: int, ndim: int = 1, device=None):
        return v % self.p

    def from_ints(self, values, device) -> torch.Tensor:
        return _to([v % self.p for v in values], device)

    def to_ints(self, x: torch.Tensor) -> list[int]:
        return [int(v) for v in x.cpu().reshape(-1)]

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def mul(self, a, b):
        p = self.p
        return ((a * (b >> 16)) % p * 65536 + a * (b & 0xFFFF)) % p

    def zeros(self, n: int, device) -> torch.Tensor:
        return torch.zeros(n, dtype=torch.int64, device=device)


class GoldilocksField(_Field):
    """GF(2^64 - 2^32 + 1); an element tensor has shape (2, ...): the hi
    and the lo 32-bit half, each in [0, 2^32)."""

    limbs = 2
    P = (1 << 64) - (1 << 32) + 1

    def __init__(self, p: int = P):
        if p != self.P:
            raise ValueError(f"{p} is not the Goldilocks prime")
        self.p = p

    def const(self, v: int, ndim: int = 1, device=None) -> torch.Tensor:
        """A constant shaped to broadcast against elements of `ndim` axes
        past the limb axis."""
        v %= self.p
        return _to([v >> 32, v & M32], device).reshape((2,) + (1,) * ndim)

    def from_ints(self, values, device) -> torch.Tensor:
        vals = [v % self.p for v in values]
        return _to([[v >> 32 for v in vals], [v & M32 for v in vals]],
                   device)

    def to_ints(self, x: torch.Tensor) -> list[int]:
        hi, lo = x.cpu().reshape(2, -1)
        return [int(h) << 32 | int(lo_) for h, lo_ in zip(hi, lo)]

    @staticmethod
    def canon(c1: torch.Tensor, c0: torch.Tensor) -> torch.Tensor:
        """The element c1 * phi + c0 (signed digits of magnitude below
        2^40) in [0, p).  Each pass carries c0 into c1 and folds c1's
        overflow h (h phi^2 = h phi - h); three passes leave both digits
        in [0, phi), then one conditional subtraction of p."""
        for _ in range(3):
            c1 = c1 + (c0 >> 32)
            c0 = c0 & M32
            h = c1 >> 32
            c1 = (c1 & M32) + h
            c0 = c0 - h
        c1 = c1 + (c0 >> 32)
        c0 = c0 & M32
        # p = (phi - 1) phi + 1: subtract it where c1 == phi - 1, c0 >= 1
        over = (c1 == M32) & (c0 >= 1)
        c1 = torch.where(over, torch.zeros_like(c1), c1)
        c0 = torch.where(over, c0 - 1, c0)
        return torch.stack((c1, c0))

    def add(self, a, b):
        return self.canon(a[0] + b[0], a[1] + b[1])

    def sub(self, a, b):
        return self.canon(a[0] - b[0], a[1] - b[1])

    @staticmethod
    def _mul32(x, y):
        """x * y for x, y in [0, 2^32): its (hi, lo) base-phi digits."""
        u = x * (y & 0xFFFF)  # < 2^48
        t = x * (y >> 16)  # < 2^48
        lo = (u & M32) + ((t & 0xFFFF) << 16)
        hi = (u >> 32) + (t >> 16) + (lo >> 32)
        return hi, lo & M32

    def mul(self, a, b):
        """(a1 phi + a0)(b1 phi + b0) = A phi^2 + B phi + C, each product
        as two digits; phi^3 = -1 and phi^2 = phi - 1 fold it to
        (Al + Bh + Bl + Ch) phi + (Cl - Ah - Al - Bh)."""
        ah, al = self._mul32(a[0], b[0])
        b1h, b1l = self._mul32(a[0], b[1])
        b2h, b2l = self._mul32(a[1], b[0])
        ch, cl = self._mul32(a[1], b[1])
        bh, bl = b1h + b2h, b1l + b2l
        return self.canon(al + bh + bl + ch, cl - ah - al - bh)

    def zeros(self, n: int, device) -> torch.Tensor:
        return torch.zeros((2, n), dtype=torch.int64, device=device)


def field_for(p: int):
    """The reference field of modulus p."""
    return GoldilocksField(p) if p == GoldilocksField.P else U32Field(p)


def powers(f, base: int, n: int, device) -> torch.Tensor:
    """[base^i for i < n] (n a power of two), by doubling: each step
    appends the block so far times base^len."""
    out = f.from_ints([1], device)
    b = base % f.p
    while f.lanes(out) < n:
        k = f.lanes(out)
        out = torch.cat((out, f.mul(out, f.const(pow(b, k, f.p), 1,
                                                   device))), dim=-1)
    return out[..., :n]


def inverse(f, x: torch.Tensor) -> torch.Tensor:
    """1 / x lane by lane (Fermat: x^(p - 2), square and multiply from
    the top bit); x must hold no zero."""
    out = None
    for bit in bin(f.p - 2)[2:]:
        if out is not None:
            out = f.mul(out, out)
        if bit == "1":
            out = x if out is None else f.mul(out, x)
    return out


def sum_lanes(f, x: torch.Tensor) -> int:
    """The sum of all lanes as one int, by halving with field adds (the
    lane count padded with zeros to a power of two)."""
    n = f.lanes(x)
    size = 1
    while size < n:
        size *= 2
    if size != n:
        pad = f.zeros(size - n, x.device)
        x = torch.cat((x, pad), dim=-1)
    while f.lanes(x) > 1:
        h = f.lanes(x) // 2
        x = f.add(x[..., :h], x[..., h:])
    return f.to_ints(x)[0]
