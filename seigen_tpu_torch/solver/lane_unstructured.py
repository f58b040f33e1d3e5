"""Lane-major LF2/LF4 runner for GENERAL (unstructured) meshes (``lane_u``).

Port of ``seigen_tpu/solver/lane_unstructured.py``.  Same lane-major scan
state and operators as solver/lane_major.py; only the trace exchange
differs: the structured exchange is replaced by the face-bijection
exchange (ops/unstructured_exchange.py), and the class-major element
order by a Morton locality order.  The reference's production
explosive-source runs used Gmsh unstructured meshes
(``mesh/gmsh_io.read_msh``).

``fused_select=True`` (default) hands the operators raw per-face panels
and runs the (f2, pi)-select inside them (K4/K5 mode SEL);
``fused_select=False`` assembles consumer traces first (u traces by one
gather, sigma as producer-contracted tractions) for K4 mode TRAC and K5
mode TR.
"""

from __future__ import annotations

import numpy as np

from ..ops.elastic import ElasticParams, voigt_map
from ..ops.unstructured_exchange import (
    derive_face_pairing,
    make_panel_gather,
    make_unstructured_exchange_lm,
    make_unstructured_traction_exchange,
    permute_pairing,
)
from .lane_major import LaneMajorRunner


class UnstructuredLaneRunner(LaneMajorRunner):
    """Lane-major runner for arbitrary conforming simplicial meshes.

    ``centroids`` (E, dim), when given, drives a Morton locality ordering
    (neighbour gathers become mostly short-range); identity otherwise.
    ``stiffness`` (see LaneMajorRunner) follows the lanes into that order.
    """

    def __init__(self, p: ElasticParams, dt: float, *, centroids=None,
                 fused_select: bool = True, **kw):
        self._centroids = None if centroids is None else np.asarray(centroids)
        self._fused_select = fused_select
        super().__init__(p, None, dt, **kw)

    def _element_perm(self):
        E = self.E
        if self._centroids is None:
            ident = np.arange(E, dtype=np.int64)
            return ident, ident.copy()
        # imported here: parallel/ builds its runners on this module
        from ..parallel.partition import morton_order

        old_of_new = np.asarray(morton_order(self._centroids),
                                dtype=np.int64)
        new_of_old = np.empty(E, dtype=np.int64)
        new_of_old[old_of_new] = np.arange(E)
        return old_of_new, new_of_old

    def _make_exchanges(self):
        p, d, E = self.p, self.d, self.E
        pr = derive_face_pairing(p.nbr.cpu().numpy(), p.n_p, p.fnodes)
        pr = permute_pairing(pr, self._old_of_new, self._new_of_old)
        self.pairing = pr
        if self._fused_select:
            self._pg_u = make_panel_gather(
                pr, d.npp, d.ftpp, d.dim, E, p.fnodes, device=p.device)
            self._pg_t = make_panel_gather(
                pr, d.npp, d.ftpp, d.dim, E, p.fnodes, nrm_lm=d.nrm,
                voigt=voigt_map(d.dim), n_sig=d.n_sig)
            return None, None  # the panels replace the assembled traces
        ex_u = make_unstructured_exchange_lm(
            pr, d.ftpp, d.dim, E, p.fnodes, device=p.device)
        # sigma traces ride as pre-contracted tractions (dim rows instead
        # of n_sig), consumed by vel_op_lm_trac
        ex_t = make_unstructured_traction_exchange(
            pr, d.npp, d.ftpp, d.dim, d.n_sig, E, p.fnodes, d.nrm,
            voigt_map(d.dim))
        return ex_u, ex_t

    def _vel(self, s_lm):
        if self._fused_select:
            fn, combo, sign, selcfg = self._pg_t
            return self._op("vel_op_lm_trac_sel")(
                self.d, s_lm, fn(s_lm), combo, sign, selcfg)
        return self._op("vel_op_lm_trac")(self.d, s_lm, self.ex_s(s_lm))

    def _stress(self, u_lm):
        if self._fused_select:
            fn, combo, _, selcfg = self._pg_u
            return self._op("stress_op_lm_sel")(
                self.d, u_lm, fn(u_lm), combo, selcfg, cmat=self.cmat)
        return self._op("stress_op_lm")(self.d, u_lm, self.ex_u(u_lm),
                                        cmat=self.cmat)
