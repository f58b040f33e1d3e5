from .quadrature import simplex_quadrature, tri_quadrature, tet_quadrature
from .tables import RefElem, ref_elem, monomial_exponents

__all__ = [
    "simplex_quadrature",
    "tri_quadrature",
    "tet_quadrature",
    "RefElem",
    "ref_elem",
    "monomial_exponents",
]
