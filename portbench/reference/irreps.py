"""Irreducible-representation (irreps) algebra for O(3)/SO(3).

Copy of ``sevennet_exp_tpu/irreps.py`` (pure Python, no framework), kept
here so the PyTorch port imports nothing of the JAX package.

A from-scratch reimplementation of the subset of e3nn's
``o3.Irrep``/``o3.Irreps`` semantics that SevenNet relies on
(cf. reference sevenn/nn/convolution.py:60-81, sevenn/util.py:163-185).
The canonical ordering, sorting and simplification rules match e3nn >= 0.5
exactly, because instruction generation and checkpoint weight layouts
depend on them.

Conventions:
  - an irrep is (l, p) with l >= 0 and p in {+1, -1}
  - string form: f"{l}{'e' if p==1 else 'o'}"
  - ordering key: (l, -p * (-1)**l)  -> 0e < 0o < 1o < 1e < 2e < 2o < 3o < 3e

Frozen copy of ``sevennet_exp_tpu_torch/irreps.py`` for the benchmark's
plain reference, which imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Iterator, List, NamedTuple, Sequence, Tuple, Union


class Irrep(NamedTuple):
    l: int
    p: int

    @staticmethod
    def make(x: Union['Irrep', str, Tuple[int, int]]) -> 'Irrep':
        if isinstance(x, Irrep):
            return x
        if isinstance(x, str):
            x = x.strip()
            l = int(x[:-1])
            p = {'e': 1, 'o': -1}[x[-1]]
            return Irrep(l, p)
        if isinstance(x, tuple):
            l, p = x
            if isinstance(p, str):
                p = {'e': 1, 'o': -1}[p]
            return Irrep(int(l), int(p))
        raise ValueError(f'cannot interpret {x!r} as an Irrep')

    @property
    def dim(self) -> int:
        return 2 * self.l + 1

    def sort_key(self):
        # e3nn Irrep.__lt__ ordering: 0e,0o,1o,1e,2e,2o,3o,3e,...
        return (self.l, -self.p * (-1) ** self.l)

    def __mul__(self, other: 'Irrep') -> Iterator['Irrep']:
        """Selection rule: |l1-l2| .. l1+l2 with parity p1*p2."""
        other = Irrep.make(other)
        p = self.p * other.p
        for l in range(abs(self.l - other.l), self.l + other.l + 1):
            yield Irrep(l, p)

    def __repr__(self) -> str:
        return f"{self.l}{'e' if self.p == 1 else 'o'}"


class MulIrrep(NamedTuple):
    mul: int
    ir: Irrep

    @property
    def dim(self) -> int:
        return self.mul * self.ir.dim

    def __repr__(self) -> str:
        return f'{self.mul}x{self.ir}'


class Irreps(tuple):
    """Immutable sequence of (mul, Irrep), e.g. Irreps('128x0e+64x1e')."""

    def __new__(cls, irreps: Union[str, 'Irreps', Sequence, None] = None):
        if irreps is None:
            return super().__new__(cls, ())
        if isinstance(irreps, Irreps):
            return super().__new__(cls, tuple(irreps))
        out: List[MulIrrep] = []
        if isinstance(irreps, str):
            if irreps.strip():
                for term in irreps.split('+'):
                    term = term.strip()
                    if 'x' in term:
                        mul, ir = term.split('x')
                        out.append(MulIrrep(int(mul), Irrep.make(ir)))
                    else:
                        out.append(MulIrrep(1, Irrep.make(term)))
        else:
            for entry in irreps:
                if isinstance(entry, MulIrrep):
                    out.append(entry)
                elif isinstance(entry, Irrep):
                    out.append(MulIrrep(1, entry))
                else:
                    mul, ir = entry
                    out.append(MulIrrep(int(mul), Irrep.make(ir)))
        return super().__new__(cls, tuple(out))

    # -- properties ------------------------------------------------------
    @property
    def dim(self) -> int:
        return sum(mi.dim for mi in self)

    @property
    def lmax(self) -> int:
        if len(self) == 0:
            raise ValueError('empty irreps has no lmax')
        return max(mi.ir.l for mi in self)

    def slices(self) -> List[slice]:
        res, i = [], 0
        for mi in self:
            res.append(slice(i, i + mi.dim))
            i += mi.dim
        return res

    def count(self, ir) -> int:  # type: ignore[override]
        ir = Irrep.make(ir)
        return sum(mi.mul for mi in self if mi.ir == ir)

    def __contains__(self, item) -> bool:
        if isinstance(item, (Irrep, str)):
            try:
                ir = Irrep.make(item)
            except Exception:
                return super().__contains__(item)
            return any(mi.ir == ir for mi in self)
        return super().__contains__(item)

    # -- algebra ---------------------------------------------------------
    def __add__(self, other) -> 'Irreps':  # type: ignore[override]
        return Irreps(tuple(self) + tuple(Irreps(other)))

    def simplify(self) -> 'Irreps':
        """Merge *adjacent* equal irreps (e3nn semantics)."""
        out: List[MulIrrep] = []
        for mi in self:
            if out and out[-1].ir == mi.ir:
                out[-1] = MulIrrep(out[-1].mul + mi.mul, mi.ir)
            elif mi.mul > 0:
                out.append(mi)
        return Irreps(out)

    def sort(self) -> 'Tuple[Irreps, Tuple[int, ...], Tuple[int, ...]]':
        """Stable sort by irrep; returns (sorted, p, inv) like e3nn.

        p[old_index] = new_index; inv[new_index] = old_index.
        """
        inv = tuple(
            sorted(range(len(self)), key=lambda i: self[i].ir.sort_key())
        )
        p = tuple(inv.index(i) for i in range(len(self)))
        srt = Irreps([self[i] for i in inv])
        return srt, p, inv

    @staticmethod
    def spherical_harmonics(lmax: int, p: int = -1) -> 'Irreps':
        return Irreps([(1, Irrep(l, p ** l)) for l in range(lmax + 1)])

    def __repr__(self) -> str:
        return '+'.join(repr(mi) for mi in self) if len(self) else ''


def full_tensor_product_irreps(irreps_1: Irreps, irreps_2: Irreps) -> Irreps:
    """Output irreps of e3nn FullTensorProduct: sorted & simplified.

    Mirrors reference sevenn/util.py:163-185 (infer_irreps_out core).
    """
    out: List[MulIrrep] = []
    for mul1, ir1 in irreps_1:
        for mul2, ir2 in irreps_2:
            for ir3 in ir1 * ir2:
                out.append(MulIrrep(mul1 * mul2, ir3))
    srt, _, _ = Irreps(out).sort()
    return srt.simplify()


def infer_irreps_out(
    irreps_x: Irreps,
    irreps_operand: Irreps,
    drop_l: Union[bool, int] = False,
    parity_mode: str = 'full',
    fix_multiplicity: Union[bool, int] = False,
) -> Irreps:
    """Port of reference sevenn/util.py:163-185 (infer_irreps_out)."""
    assert parity_mode in ('full', 'even', 'sph')
    irreps_out = full_tensor_product_irreps(irreps_x, irreps_operand)
    elems: List[MulIrrep] = []
    for mul, ir in irreps_out:
        l, p = ir
        if drop_l is not False and l > drop_l:
            continue
        if parity_mode == 'even' and p == -1:
            continue
        if parity_mode == 'sph' and p != (-1) ** l:
            continue
        if fix_multiplicity:
            mul = int(fix_multiplicity)
        elems.append(MulIrrep(mul, ir))
    return Irreps(elems)
