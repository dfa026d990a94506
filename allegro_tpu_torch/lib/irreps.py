"""O(3) irreducible-representation bookkeeping (the same code as
``allegro_tpu/lib/irreps.py``, which the port cannot import: that package's
``lib`` pulls in JAX).

A minimal, dependency-free replacement for the slice of ``e3nn.o3.Irreps``
API the Allegro architecture needs (cf. reference usage at
``allegro/nn/_allegro.py:8`` and ``allegro/model/allegro_models.py:79-86``):
parsing, dims/slices, selection rules, and the derived irreps ladders.

Conventions
-----------
- An irrep of O(3) is ``(l, p)`` with degree ``l >= 0`` and parity
  ``p in {+1, -1}``, printed ``"0e"``, ``"1o"``, etc.
- ``Irreps`` is an ordered tuple of ``(mul, Irrep)`` pairs, printed
  ``"32x0e+8x1o"``.
- Basis ordering within an irrep is ``m = -l..l`` (matches our real spherical
  harmonics, see ``spherical_harmonics.py``).
"""

from __future__ import annotations

import itertools
import re
from typing import Iterator, NamedTuple, Sequence, Tuple, Union


class Irrep(tuple):
    """A single O(3) irrep: degree ``l`` and parity ``p`` (+1 even / -1 odd)."""

    @classmethod
    def parse(cls, s: Union[str, "Irrep", Tuple[int, int]]) -> "Irrep":
        if isinstance(s, Irrep):
            return s
        if isinstance(s, tuple):
            l, p = s
            return cls(int(l), int(p))
        m = re.fullmatch(r"\s*(\d+)\s*([eoy])\s*", s)
        if m is None:
            raise ValueError(f"cannot parse irrep {s!r}")
        l = int(m.group(1))
        tag = m.group(2)
        if tag == "e":
            p = 1
        elif tag == "o":
            p = -1
        else:  # "y": spherical-harmonic parity (-1)**l
            p = (-1) ** l
        return cls(l, p)

    def __new__(cls, l, p=None):
        if p is None:
            return Irrep.parse(l)
        l = int(l)
        p = int(p)
        if l < 0:
            raise ValueError(f"l must be >= 0, got {l}")
        if p not in (1, -1):
            raise ValueError(f"p must be +1 or -1, got {p}")
        return super().__new__(cls, (l, p))

    @property
    def l(self) -> int:  # noqa: E743
        return self[0]

    @property
    def p(self) -> int:
        return self[1]

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def __mul__(self, other: "Irrep") -> Iterator["Irrep"]:
        """Selection rule: the irreps appearing in the tensor product."""
        other = Irrep.parse(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"

    def __str__(self) -> str:
        return repr(self)

    def __lt__(self, other) -> bool:  # order by l, even before odd at equal l
        other = Irrep.parse(other)
        return (self.l, -self.p) < (other.l, -other.p)


class MulIrrep(NamedTuple):
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self) -> str:
        return f"{self.mul}x{self.ir}"


IrrepsLike = Union[str, "Irreps", Irrep, Sequence]


class Irreps(tuple):
    """Ordered direct sum of irreps with multiplicities."""

    def __new__(cls, irreps: IrrepsLike = ()) -> "Irreps":
        if isinstance(irreps, Irreps):
            return super().__new__(cls, irreps)
        out = []
        if isinstance(irreps, Irrep):
            out.append(MulIrrep(1, irreps))
        elif isinstance(irreps, str):
            s = irreps.strip()
            if s:
                for term in s.split("+"):
                    term = term.strip()
                    if "x" in term:
                        mul_s, ir_s = term.split("x")
                        out.append(MulIrrep(int(mul_s), Irrep.parse(ir_s)))
                    else:
                        out.append(MulIrrep(1, Irrep.parse(term)))
        else:
            for item in irreps:
                if isinstance(item, MulIrrep):
                    out.append(item)
                elif isinstance(item, Irrep):
                    out.append(MulIrrep(1, item))
                elif isinstance(item, str):
                    out.extend(Irreps(item))
                else:
                    mul, ir = item
                    out.append(MulIrrep(int(mul), Irrep.parse(ir)))
        return super().__new__(cls, out)

    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def num_irreps(self) -> int:
        return sum(mi.mul for mi in self)

    @property
    def ls(self) -> list:
        return [mi.ir.l for mi in self for _ in range(mi.mul)]

    @property
    def lmax(self) -> int:
        if not self:
            raise ValueError("empty irreps has no lmax")
        return max(mi.ir.l for mi in self)

    def slices(self) -> list:
        out = []
        i = 0
        for mi in self:
            out.append(slice(i, i + mi.dim))
            i += mi.dim
        return out

    def count(self, ir) -> int:  # type: ignore[override]
        ir = Irrep.parse(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __contains__(self, ir) -> bool:  # type: ignore[override]
        ir = Irrep.parse(ir)
        return any(mi.ir == ir and mi.mul > 0 for mi in self)

    def __add__(self, other) -> "Irreps":  # type: ignore[override]
        return Irreps(tuple.__add__(self, Irreps(other)))

    def __mul__(self, n: int) -> "Irreps":  # type: ignore[override]
        return Irreps(tuple.__mul__(self, n))

    def __rmul__(self, n: int) -> "Irreps":  # type: ignore[override]
        return self.__mul__(n)

    def repeat(self, mul: int) -> "Irreps":
        """Scale every multiplicity by ``mul``."""
        return Irreps([MulIrrep(mi.mul * mul, mi.ir) for mi in self])

    def merged(self) -> "Irreps":
        """Combine adjacent equal irreps; drop zero multiplicities."""
        out = []
        for mi in self:
            if mi.mul == 0:
                continue
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            else:
                out.append(mi)
        return Irreps(out)

    def sorted(self) -> "Irreps":
        return Irreps(sorted(self, key=lambda mi: (mi.ir.l, -mi.ir.p)))

    def regroup(self) -> "Irreps":
        return self.sorted().merged()

    def filter(self, keep) -> "Irreps":
        keep_set = {Irrep.parse(ir) for ir in Irreps(keep).irs} if not callable(keep) else None
        if keep_set is not None:
            return Irreps([mi for mi in self if mi.ir in keep_set])
        return Irreps([mi for mi in self if keep(mi)])

    @property
    def irs(self) -> list:
        return [mi.ir for mi in self]

    @classmethod
    def spherical_harmonics(cls, lmax: int, p: int = -1) -> "Irreps":
        """Irreps of spherical harmonics up to ``lmax``.

        ``p=-1`` gives the physical SH parities ``(-1)**l``
        (cf. reference ``allegro/model/allegro_models.py:76``); ``p=1`` gives
        all-even (parity-off mode).
        """
        if p not in (1, -1):
            raise ValueError("p must be +1 or -1")
        return cls([MulIrrep(1, Irrep(l, p**l)) for l in range(lmax + 1)])

    def __repr__(self) -> str:
        return "+".join(f"{mi.mul}x{mi.ir}" for mi in self) if len(self) else ""

    def __str__(self) -> str:
        return repr(self)


def tp_path_exists(irreps_in1: IrrepsLike, irreps_in2: IrrepsLike, ir_out) -> bool:
    """True if ``ir_out`` appears in the product of any pair of input irreps.

    Mirrors the role of ``nequip.nn.tp_path_exists`` consumed at reference
    ``allegro/nn/_allegro.py:12,126``.
    """
    irreps_in1 = Irreps(irreps_in1)
    irreps_in2 = Irreps(irreps_in2)
    ir_out = Irrep.parse(ir_out)
    for mi1, mi2 in itertools.product(irreps_in1, irreps_in2):
        if ir_out in mi1.ir * mi2.ir:
            return True
    return False
