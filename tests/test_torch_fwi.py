"""The port's FWI loop, shots, imaging and the fwi/rtm programs against the
JAX package (f64, CPU).

1. ``lowpass_taps``/``lowpass`` and ``make_smoother`` give JAX's arrays.
2. ``stack_shots`` pads as JAX's does; ``run_shots`` gives the same numbers
   with batch "vmap", "map" and "host", and JAX's ``run_shots``.
3. ``imaging``: ``element_neighbours``, ``laplacian_filter``,
   ``acquisition_mute``, ``normalize`` and ``source_illumination`` give
   JAX's.
4. ``invert``: Adam and max-normalised descent iterates (2 iterations,
   smoothing and bounds on) match JAX's ``invert`` (optax) fed the port's
   einsum gradient; L-BFGS (torch's strong-Wolfe search, not optax's zoom search:
   the iterates differ) reduces the misfit; a resumed inversion equals the
   uninterrupted one bitwise, mid-band and at a band boundary.
5. ``cli.fwi`` and ``cli.rtm`` run with ``--cpu`` at a tiny size: their
   flags, the summary's keys and the refusal of the multi-device flags.

Tolerance: rtol 1e-10, atol 1e-12 * max|ref|.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import seigen_tpu.mesh as jmesh
import seigen_tpu.ops as jops
import seigen_tpu.solver as jsol
import seigen_tpu_torch.mesh as tmesh
import seigen_tpu_torch.ops as tops
import seigen_tpu_torch.solver as tsol
from seigen_tpu.solver import adjoint as jadj
from seigen_tpu.solver import fwi as jfwi
from seigen_tpu.solver import imaging as jimg
from seigen_tpu.solver import shots as jshots
from seigen_tpu_torch.cli import fwi as fwi_cli
from seigen_tpu_torch.cli import rtm as rtm_cli
from seigen_tpu_torch.solver import fwi as tfwi
from seigen_tpu_torch.solver import imaging as timg
from seigen_tpu_torch.solver import shots as tshots
from seigen_tpu_torch.solver.adjoint import with_material

F64 = torch.float64
RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tiny CPU operators gain nothing from intra-op threads, and
    several pytest workers' thread pools fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, rtol=RTOL, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-12 * np.abs(ref).max(),
                               err_msg=err_msg)


def test_lowpass_and_smoother_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 50, 3, 2))
    tj = jfwi.lowpass_taps(0.01, 5.0, dtype=jnp.float64)
    tt = tfwi.lowpass_taps(0.01, 5.0, dtype=F64, device="cpu")
    close(tt, tj, rtol=1e-15)
    close(tfwi.lowpass(torch.as_tensor(x), tt, axis=1),
          jfwi.lowpass(jnp.asarray(x), tj, axis=1), rtol=1e-12)
    dm = tmesh.build_discrete(tmesh.rect_mesh(6, 6), 1)
    pt = tops.build_params(dm, tops.Material(1.0, 2.0, 1.0), dtype=F64,
                           device="cpu")
    pj = jops.build_params(jmesh.build_discrete(jmesh.rect_mesh(6, 6), 1),
                           jops.Material(1.0, 2.0, 1.0), dtype=jnp.float64)
    g = rng.standard_normal(dm.num_elements)
    close(tfwi.make_smoother(pt, 3, 0.4)(torch.as_tensor(g)),
          jfwi.make_smoother(pj, 3, 0.4)(jnp.asarray(g)), rtol=1e-13)
    # imaging post-processing on the same element fields
    np.testing.assert_array_equal(timg.element_neighbours(pt),
                                  jimg.element_neighbours(pj))
    close(timg.laplacian_filter(pt, g, iters=2),
          jimg.laplacian_filter(pj, g, iters=2), rtol=1e-13)
    cent = dm.coords.mean(axis=1)
    pts = np.array([[0.3, 0.8], [0.6, 0.9]])
    np.testing.assert_array_equal(timg.acquisition_mute(cent, pts, 0.2),
                                  jimg.acquisition_mute(cent, pts, 0.2))
    np.testing.assert_array_equal(timg.normalize(torch.as_tensor(g)),
                                  jimg.normalize(g))


def build(n=4, n_steps=16):
    """The same tiny 2D acquisition in both packages: free top, sponge,
    two mollified shots (the second with more entries: padding), six
    receivers, a shallow vp anomaly as the true model."""
    out = []
    for mesh, ops, sol, dtype, kw in (
            (jmesh, jops, jsol, jnp.float64, {}),
            (tmesh, tops, tsol, F64, {"device": "cpu"})):
        dm = mesh.build_discrete(
            mesh.rect_mesh(n, n), 1,
            bc_fn=sol.absorbing_bc_fn(((0.0, 1.0),) * 2,
                                      free_sides=[(1, "hi")]))
        h = float(dm.h.min())
        E, n_p = dm.num_elements, dm.re.n_p
        cent = dm.coords.mean(axis=1)
        vp_true = 2.0 - 0.25 * np.exp(-(((cent[:, 0] - 0.5) ** 2
                                         + (cent[:, 1] - 0.7) ** 2)
                                        / (2 * 0.12**2)))
        p0 = ops.build_params(dm, ops.Material(rho=1.0, vp=2.0, vs=1.0),
                              dtype=dtype, **kw)
        f0 = 8.0
        shots = [sol.build_sources(dm, [sol.PointSource(
            position=(x, 0.8), f0=f0, t0=0.08, radius=r * h)],
            dtype=dtype, **kw)
            for x, r in ((0.3, 1.0), (0.7, 2.0))]
        rcv = sol.build_receivers(dm, sol.line((0.15, 0.9), (0.85, 0.9), 6),
                                  dtype=dtype, **kw)
        damp = sol.sponge_mask(dm, [(0, "lo"), (0, "hi"), (1, "lo")],
                               width=0.2)
        if dtype is F64:
            damp = torch.as_tensor(damp, dtype=F64)
            st = tsol.State(u=torch.zeros(E, n_p, 2, dtype=F64),
                            s=torch.zeros(E, n_p, 3, dtype=F64))
            stacked = tshots.stack_shots(shots)
        else:
            damp = jnp.asarray(damp)
            st = jsol.State(u=jnp.zeros((E, n_p, 2)),
                            s=jnp.zeros((E, n_p, 3)))
            stacked = jshots.stack_shots(shots)
        out.append(dict(dm=dm, p0=p0, shots=stacked, rcv=rcv, damp=damp,
                        st=st, dt=sol.cfl_dt(h, 2.0, 1, 0.4), n=n_steps,
                        vp_true=vp_true, f0=f0))
    return out


@pytest.fixture(scope="module")
def case():
    j, t = build()
    # batch="map": one shot body to compile (JAX's vmap is the same
    # arithmetic, tests/test_shots.py:138)
    _, seis = jshots.run_shots(
        jadj.with_material(j["p0"], vp=jnp.asarray(j["vp_true"])), j["st"],
        j["dt"], j["n"], j["shots"], receivers=j["rcv"], damp=j["damp"],
        batch="map")
    obs = np.asarray(seis)
    return j, t, obs


def test_stack_and_run_shots_match_jax(case):
    j, t, obs = case
    for f in ("elems", "vec_u", "vec_s", "f0", "t0", "amp"):
        np.testing.assert_allclose(getattr(t["shots"], f).numpy(),
                                   np.asarray(getattr(j["shots"], f)),
                                   rtol=1e-15, atol=0, err_msg=f)
    p_true = with_material(t["p0"], vp=t["vp_true"])
    runs = {b: tshots.run_shots(p_true, t["st"], t["dt"], t["n"],
                                t["shots"], receivers=t["rcv"],
                                damp=t["damp"], batch=b,
                                segment=4 if b == "map" else None)
            for b in ("vmap", "map", "host")}
    for b, (fin, seis) in runs.items():
        assert seis.shape == obs.shape
        close(seis, obs, err_msg=b)
        close(fin.u, runs["vmap"][0].u, rtol=1e-12, err_msg=b)
    v = tshots.shots_misfit(p_true, t["st"], t["dt"], t["n"], t["shots"],
                            t["rcv"], torch.as_tensor(0.5 * obs),
                            damp=t["damp"])
    np.testing.assert_allclose(float(v), 0.125 * np.sum(obs * obs),
                               rtol=RTOL)


def test_source_illumination_matches_jax(case):
    j, t, _ = case
    close(timg.source_illumination(t["p0"], t["st"], t["dt"], t["n"],
                                   t["shots"], damp=t["damp"]),
          jimg.source_illumination(j["p0"], j["st"], j["dt"], j["n"],
                                   j["shots"], damp=j["damp"]))


@pytest.mark.parametrize("optimizer", ["adam", "gd"])
def test_invert_matches_jax(case, optimizer):
    """The port's invert against JAX's invert (optax Adam / sgd(1.0) on the
    max-normalised gradient, smoothing, bounds).  JAX's is fed the port's
    einsum gradient as numpy arrays, so the iterates compare the loops
    alone; the gradients themselves are held to JAX's in
    test_torch_adjoint.py."""
    j, t, obs = case
    kw = dict(fields=("vp",), optimizer=optimizer, lr=0.02, iters=2,
              smooth_iters=1, bounds={"vp": (1.5, 2.5)})
    tvg = tfwi_vg(t, obs)

    def jax_vg(th):
        v, g = tvg({"vp": np.asarray(th["vp"])})
        return v, {"vp": jnp.asarray(g["vp"].numpy())}

    ref = jfwi.invert(j["p0"], j["st"], j["dt"], j["n"], j["shots"],
                      j["rcv"], obs, damp=j["damp"],
                      vg_factory=lambda taps: jax_vg, **kw)
    res = tfwi.invert(t["p0"], t["st"], t["dt"], t["n"], t["shots"],
                      t["rcv"], obs, damp=t["damp"], **kw)
    np.testing.assert_allclose(res.misfits, ref.misfits, rtol=RTOL)
    assert res.misfits[1] < res.misfits[0]
    close(res.theta["vp"], ref.theta["vp"])
    assert res.bands == [{"fc": None, "misfit_end": res.misfits[-1]}]


def tfwi_vg(t, obs):
    """The port's einsum value-and-gradient over the case's shots (what
    invert computes on its default path)."""
    from seigen_tpu_torch.solver.adjoint import make_fwi_gradient

    vgs = [make_fwi_gradient(t["p0"], t["st"], t["dt"], t["n"],
                             tshots.shot_at(t["shots"], k), t["rcv"], obs[k],
                             fields=("vp",), damp=t["damp"])[0]
           for k in range(len(obs))]

    def vg(th):
        out = [f(th) for f in vgs]
        return sum(v for v, _ in out), {"vp": sum(g["vp"] for _, g in out)}

    return vg


def first_shot(t, obs):
    """The case cut to its first shot (the tests of the loop itself)."""
    return tshots.stack_shots([tshots.shot_at(t["shots"], 0)]), obs[:1]


def test_invert_lbfgs_reduces_misfit(case):
    _, t, obs = case
    shots, obs = first_shot(t, obs)
    res = tfwi.invert(t["p0"], t["st"], t["dt"], t["n"], shots,
                      t["rcv"], obs, damp=t["damp"], fields=("vp",),
                      optimizer="lbfgs", iters=3, smooth_iters=0,
                      bounds={"vp": (1.5, 2.5)}, batch="host")
    assert res.misfits[-1] < 0.5 * res.misfits[0], res.misfits


def test_invert_checkpoint_resume_bitwise(case, tmp_path):
    """A resumed inversion is the uninterrupted one bitwise (theta, misfit
    history, band log), from a mid-band and a band-boundary checkpoint;
    the npz keeps the JAX package's keys for the model and history."""
    _, t, obs = case
    kw = dict(fields=("vp",), optimizer="adam", lr=0.02, iters=2,
              bands=(0.5 * t["f0"], None), smooth_iters=1,
              bounds={"vp": (1.5, 2.5)}, damp=t["damp"], batch="host")
    shots, obs = first_shot(t, obs)
    args = (t["p0"], t["st"], t["dt"], t["n"], shots, t["rcv"], obs)
    ref = tfwi.invert(*args, **kw)
    cka = str(tmp_path / "cut_midband")
    tfwi.invert(*args, **{**kw, "iters": 1, "bands": (0.5 * t["f0"],)},
                checkpoint_path=cka)
    ckb = str(tmp_path / "cut_boundary")
    tfwi.invert(*args, **{**kw, "bands": (0.5 * t["f0"],)},
                checkpoint_path=ckb)
    data = np.load(cka + ".npz")
    assert {"band_idx", "it", "misfits", "band_log", "theta_keys",
            "theta_vp", "opt_state"} <= set(data.files)
    for ck in (cka, ckb):
        res = tfwi.invert(*args, **kw, checkpoint_path=ck, resume=True)
        assert torch.equal(res.theta["vp"], ref.theta["vp"]), ck
        assert res.misfits == ref.misfits, ck
        assert res.bands == ref.bands, ck


def run_main(mod, argv, capsys):
    """(exit code, the summary JSON line) of a program run in-process."""
    rc = mod.main(argv)
    out = capsys.readouterr().out.splitlines()
    return rc, json.loads(next(ln for ln in reversed(out)
                               if ln.startswith("{")))


FWI_TINY = ["--n", "4", "--degree", "1", "--iters", "2", "--shots", "1",
            "--receivers", "4", "--T", "0.1", "--cpu", "--f64"]


@pytest.mark.parametrize("extra", [
    ["--grad-path", "roll", "--batch", "host", "--optimizer", "gd"],
    ["--grad-path", "roll", "--batch", "map"],
    ["--grad-path", "merged", "--segment", "2", "--precond", "illum"],
    ["--grad-path", "lane_u", "--bands", "1"],
    ["--invert-q"],
])
def test_fwi_cli_runs(extra, tmp_path, capsys):
    rc, s = run_main(fwi_cli, FWI_TINY + extra + [
        "--out", str(tmp_path / "m.npz")], capsys)
    assert rc == 0
    keys = ({"mode", "qinv_err_init", "qinv_err_final"} if "--invert-q"
            in extra else {"grad_path", "optimizer", "band_log",
                           "model_err_init", "model_err_final"})
    assert keys | {"E", "n_steps", "misfit_first", "misfit_last",
                   "wall_s"} <= set(s)
    assert (tmp_path / "m.npz").exists()


def test_fwi_cli_checkpoint_and_refusals(tmp_path, capsys):
    ck = str(tmp_path / "inv")
    argv = FWI_TINY + ["--grad-path", "lane", "--inv-checkpoint", ck]
    rc, s = run_main(fwi_cli, argv, capsys)
    assert rc == 0 and (tmp_path / "inv.npz").exists()
    rc, s2 = run_main(fwi_cli, argv + ["--inv-resume"], capsys)
    assert rc == 0 and s2["misfit_last"] == s["misfit_last"]
    for flags, why in ((["--grad-shards", "2", "--dd-shards", "2"],
                        "exclusive"),
                       (["--grad-path", "roll", "--dd-shards", "2"],
                        "--grad-path"),
                       (["--grad-path", "lane", "--dd-shards", "2",
                         "--est-source"], "one device")):
        with pytest.raises(SystemExit, match=why):
            fwi_cli.main(FWI_TINY + flags)


@pytest.mark.parametrize("flags", [
    ["--grad-path", "lane", "--grad-shards", "2"],
    ["--grad-path", "merged", "--dd-shards", "2"],
], ids=["grad-shards", "dd-shards"])
def test_fwi_cli_shards_match_the_unsharded_run(flags, tmp_path):
    """fwi --grad-shards 2 / --dd-shards 2 --cpu (two gloo ranks the CLI
    spawns; rank 0 writes) inverts as the unsharded run does: the same
    misfit history and final model."""
    argv = FWI_TINY + ["--shots", "2", "--T", "0.3"] + flags[:2]
    one, two = tmp_path / "one.npz", tmp_path / "two.npz"
    assert fwi_cli.main(argv + ["--out", str(one)]) == 0
    assert fwi_cli.main(argv + flags[2:] + ["--out", str(two)]) == 0
    a, b = np.load(one), np.load(two)
    assert np.abs(a["misfits"]).min() > 0
    for k in ("misfits", "vp_final"):
        np.testing.assert_allclose(b[k], a[k], rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("extra", [
    ["--grad-path", "einsum", "--reflect", "vp"],
    ["--grad-path", "lane", "--free-top", "--segment", "2"],
])
def test_rtm_cli_runs(extra, tmp_path, capsys):
    js = tmp_path / "rtm.json"
    rc = rtm_cli.main(["--n", "4", "--degree", "1", "--shots", "2",
                       "--receivers", "4", "--T", "0.1", "--cpu", "--f64",
                       "--json", str(js), "--out", str(tmp_path / "i.npz")]
                      + extra)
    assert rc == 0
    s = json.loads(js.read_text())
    assert {"z_imaged", "z_error", "z_rms_spread", "focus", "focus_band",
            "misfit", "grad_path"} <= set(s)
    assert np.isfinite(s["z_error"]) and 0.0 <= s["focus"] <= 1.0
    assert (tmp_path / "i.npz").exists()
    capsys.readouterr()
