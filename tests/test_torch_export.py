"""The port's export (``py_psnode_tpu_torch/export``, the variants' recipes,
``Trainer.save`` and ``--saving``) against the JAX package's.

For each of the four ported variants at h=16, the same weights (seeded
numpy in the flax layout, loaded into the port's module with
``bridge.load_params``) go through the JAX recipe and the port's into two
``saved model/`` directories. They must hold the same files (the JAX
package's ``<name>.stablehlo`` is the port's ``<name>.pt2``), the same
``.weights.bin`` bytes, the same ``.weights.npz`` keys and arrays and the
same ``dim.txt``. Each ``.pt2`` must reload and match the flax submodule's
``apply`` (rtol 1e-5: the same float32 arithmetic in another order), and
the ``.bin`` files must load in the port's binding of the C++ runtime and
roll out as the port's plain model does (rtol 2e-4 / atol 2e-5,
``tests/test_native_runtime.py``'s bar: the runtime's float32 loop sums in
its own order over the steps).
"""

import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from py_psnode_tpu.cli.common import main as jax_main
from py_psnode_tpu.export import binfmt as jax_binfmt
from py_psnode_tpu.models import AEFunc, DEFunc, InitFunc
from py_psnode_tpu.models.funcs import ChannelWiseAEFunc, ChannelWiseDEFunc
from py_psnode_tpu.train.variants import VARIANTS as JAX_VARIANTS

from py_psnode_tpu_torch.bridge import load_params
from py_psnode_tpu_torch.cli.common import main as port_main
from py_psnode_tpu_torch.export import binfmt, native_runtime as NR
from py_psnode_tpu_torch.train.checkpoints import load_checkpoint_params
from py_psnode_tpu_torch.train.variants import VARIANTS, export_examples

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN = REPO / "benchmarks/h2h_work_prod_s0"
CKPT = RUN / "ours_dae_motor/model_checkpoint.200"
TEST_DATA = RUN / "data_dae_motor/testing.npz"

H = 16
# the AVR ODE's channels and the motor DAE's
DIMS = {"ode": dict(x_dim=2, z_dim=2), "dae": dict(x_dim=3, z_dim=1, v_dim=2, i_dim=2)}
NAMES = ["ode_no_encode", "dae_no_encode", "ode_channelwise", "dae_channelwise"]


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the C++ runtime")


def _batch(kind, B, T, rng):
    dims = DIMS[kind]
    t = np.cumsum(np.full((B, T, 1), 0.02, np.float32), axis=1) - 0.02
    out = dict(t=t.astype(np.float32), x=rng.normal(size=(B, T, dims["x_dim"])).astype(np.float32),
               z=rng.normal(size=(B, T, dims["z_dim"])).astype(np.float32))
    if kind == "dae":
        out["v"] = rng.normal(size=(B, T, dims["v_dim"])).astype(np.float32)
        out["i"] = rng.normal(size=(B, T, dims["i_dim"])).astype(np.float32)
    return out


def _weights(name):
    """(flax tree {"params": ...} of seeded numpy arrays, the JAX model, the
    port's module holding the same weights)."""
    kind = VARIANTS[name].kind
    jm = JAX_VARIANTS[name].make_model(DIMS[kind], H)
    batch = _batch(kind, 2, 4, np.random.default_rng(0))
    keys = ("t", "x", "z") if kind == "ode" else ("t", "x", "z", "v", "i")
    shapes = jm.init(jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in keys))
    rng = np.random.default_rng(11)
    tree = jax.tree_util.tree_map(
        lambda a: (0.3 * rng.standard_normal(np.shape(a))).astype(np.float32), jax.device_get(shapes))
    pm = load_params(VARIANTS[name].make_model(DIMS[kind], H, device="cpu"), tree)
    return tree, jm, pm


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per variant: (the JAX recipe's directory, the port's, the tree, the
    port's module)."""
    out = {}
    for name in NAMES:
        root = tmp_path_factory.mktemp(name)
        tree, jm, pm = _weights(name)
        kind = VARIANTS[name].kind
        JAX_VARIANTS[name].export_fn(jm, jax.tree_util.tree_map(jnp.asarray, tree), DIMS[kind], root / "jax")
        VARIANTS[name].export_fn(pm, DIMS[kind], root / "port", True)
        out[name] = (root / "jax", root / "port", tree, pm)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_port_export_writes_the_jax_packages_artifacts(exported, name):
    jdir, pdir, _, _ = exported[name]
    jfiles = {p.name for p in jdir.iterdir()}
    pfiles = {p.name for p in pdir.iterdir()}
    programs = {f for f in pfiles if f.endswith(".pt2")}
    stems = {f[: -len(".weights.npz")] for f in pfiles if f.endswith(".weights.npz")}
    assert programs == {f"{s}.pt2" for s in stems} and stems
    assert pfiles - programs == {f for f in jfiles if not f.endswith(".stablehlo")}
    assert {f for f in jfiles if f.endswith(".stablehlo")} <= {f"{s}.stablehlo" for s in stems}
    for f in sorted(pfiles - programs):
        if f.endswith(".bin") or f == "dim.txt":
            assert (pdir / f).read_bytes() == (jdir / f).read_bytes(), f
        else:
            with np.load(jdir / f) as a, np.load(pdir / f) as b:
                assert sorted(a.files) == sorted(b.files), f
                for k in a.files:
                    assert a[k].dtype == b[k].dtype == np.float32
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f}:{k}")


def _flax_module(name, sub):
    """The standalone flax submodule of the JAX recipe and random arguments
    at batch 1 (t0 a scalar)."""
    kind, rng = VARIANTS[name].kind, np.random.default_rng(3)
    d = DIMS[kind]
    xd, zd = d["x_dim"], d["z_dim"]
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    if name == "ode_no_encode":
        return DEFunc((H, H, H, xd)), (np.float32(0.0), r(1, xd + zd), r(1, xd), r(1, zd))
    vd, idim = d.get("v_dim", 0), d.get("i_dim", 0)
    if name == "dae_no_encode":
        init = r(1, xd + zd + vd + idim)
        return {"init_func": (InitFunc((H, H, xd)), (r(1, zd), r(1, vd), r(1, idim))),
                "de_func": (DEFunc((H, H, H, xd)), (np.float32(0.0), init, r(1, xd), r(1, zd), r(1, vd),
                                                    r(1, idim))),
                "ae_func": (AEFunc((H, H, H, idim)), (init, r(1, xd), r(1, zd), r(1, vd)))}[sub]
    if sub == "de_func":
        return (ChannelWiseDEFunc(x_dim=xd, z_dim=zd, hidden_dim=H),
                (np.float32(0.0), r(1, xd + zd, H), r(1, xd, H), r(1, zd)))
    return ChannelWiseAEFunc(x_dim=xd, v_dim=vd, i_dim=idim, hidden_dim=H), (r(1, xd, H), r(1, vd))


@pytest.mark.parametrize("name", NAMES)
def test_port_programs_reload_and_match_the_flax_submodules(exported, name):
    _, pdir, tree, _ = exported[name]
    for program in sorted(pdir.glob("*.pt2")):
        sub = program.name[: -len(".pt2")]
        module, args = _flax_module(name, sub)
        ref = module.apply({"params": tree["params"][sub]}, *(jnp.asarray(a) for a in args))
        with np.load(pdir / f"{sub}.weights.npz") as f:
            weights = {k: torch.tensor(f[k]) for k in f.files}
        got = torch.export.load(program).module()(weights, *(torch.tensor(a) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6, err_msg=sub)


@pytest.mark.parametrize("name", NAMES)
def test_port_bins_roll_out_in_the_native_runtime(exported, name):
    _need_gxx()
    _, pdir, _, pm = exported[name]
    kind = VARIANTS[name].kind
    pm.solver = "rk4" if "no_encode" in name else "euler"  # both the model and the runtime
    b = _batch(kind, 3, 9, np.random.default_rng(5))
    with torch.no_grad():
        ref = pm(*(torch.tensor(b[k]) for k in (("t", "x", "z") if kind == "ode" else ("t", "x", "z", "v", "i"))))
    got = NR.rollout(name, pdir, b, pm.solver)
    want = (ref,) if isinstance(ref, torch.Tensor) else ref[: len(got)]
    assert len(got) == (1 if kind == "ode" else 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_binfmt_round_trips_and_matches_the_jax_packages_bytes(tmp_path, seed):
    rng = np.random.default_rng(seed)
    flat = {"b/dense_1/kernel": rng.normal(size=(5, 3)).astype(np.float32),
            "a/dense_0/bias": rng.normal(size=(7,)).astype(np.float32),
            "c/w": rng.normal(size=(2, 3, 4)).astype(np.float64),  # written as float32
            "s": np.float32(seed + 0.5)}
    binfmt.write_weights_bin(tmp_path / "port.bin", flat)
    jax_binfmt.write_weights_bin(tmp_path / "jax.bin", flat)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    back = binfmt.read_weights_bin(tmp_path / "port.bin")
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))
    assert jax_binfmt.read_weights_bin(tmp_path / "port.bin").keys() == back.keys()


def test_binfmt_refuses_a_foreign_file(tmp_path):
    (tmp_path / "bad.bin").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="bad weights file"):
        binfmt.read_weights_bin(tmp_path / "bad.bin")


def test_port_saving_matches_the_jax_packages_saving(tmp_path):
    """``--saving --device cpu`` on a copy of the motor checkpoint 200 (h=128)
    writes the JAX ``Trainer.save()``'s ``.bin`` bytes and npz arrays."""
    dirs = {}
    for who, main, extra in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
        root = tmp_path / who
        root.mkdir()
        shutil.copy(CKPT, root / CKPT.name)
        main("dae_no_encode", ["--saving", "--model", str(root / CKPT.name), "--test_data", str(TEST_DATA)]
             + extra)
        dirs[who] = root / "saved model"
    for sub in ("init_func", "de_func", "ae_func"):
        name = f"{sub}.weights.bin"
        assert (dirs["port"] / name).read_bytes() == (dirs["jax"] / name).read_bytes(), name
        with np.load(dirs["jax"] / f"{sub}.weights.npz") as a, np.load(dirs["port"] / f"{sub}.weights.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        assert (dirs["port"] / f"{sub}.pt2").exists()


def test_port_saving_needs_a_model_and_a_test_set():
    with pytest.raises(SystemExit, match="missing"):
        port_main("dae_no_encode", ["--saving", "--device", "cpu", "--model", ""])


def test_port_training_epoch_exports_saved_model(tmp_path):
    """One small ``--training`` epoch leaves ``saved model/`` (rewritten at
    the epoch's end and after the last) and no "nothing exported" line."""
    run = tmp_path / "run"
    port_main("dae_no_encode", ["--training", "--device", "cpu", "--train_data", str(TEST_DATA),
                                "--test_data", str(TEST_DATA), "--model", str(run), "--num", "8",
                                "--batch", "4", "--hidden", "16", "--epoch", "1", "--step", "21",
                                "--larger_than", "none"])
    saved = run / "saved model"
    assert {p.name for p in saved.iterdir()} == {
        f"{s}.{ext}" for s in ("init_func", "de_func", "ae_func") for ext in ("pt2", "weights.npz", "weights.bin")}
    assert "nothing exported" not in (run / "training.log").read_text()
    with np.load(run / "model_checkpoint.1") as ckpt, np.load(saved / "de_func.weights.npz") as f:
        for k in f.files:
            np.testing.assert_array_equal(f[k], ckpt[f"params/de_func/{k}"])


def test_port_training_rewrites_the_programs_of_a_reused_directory(tmp_path):
    """A second ``--training`` run into the same ``--model`` directory at
    another ``--hidden`` rewrites the ``.pt2`` programs with the weights'
    new shapes: each reloaded program takes the new npz."""
    run = tmp_path / "run"
    for hidden in ("16", "24"):
        port_main("dae_no_encode", ["--training", "--device", "cpu", "--train_data", str(TEST_DATA),
                                    "--test_data", str(TEST_DATA), "--model", str(run), "--num", "4",
                                    "--batch", "4", "--hidden", hidden, "--epoch", "1", "--step", "11",
                                    "--larger_than", "none"])
    saved = run / "saved model"
    model = VARIANTS["dae_no_encode"].make_model(DIMS["dae"], 24, device="cpu")
    load_params(model, load_checkpoint_params(run / "model_checkpoint.1"))
    for sub, args in export_examples("dae_no_encode", model, DIMS["dae"]).items():
        with np.load(saved / f"{sub}.weights.npz") as f:
            weights = {k: torch.tensor(f[k]) for k in f.files}
        got = torch.export.load(saved / f"{sub}.pt2").module()(weights, *(torch.tensor(a) for a in args))
        with torch.no_grad():
            want = getattr(model, sub)(*(torch.tensor(a) for a in args))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_port_and_smoke_import_no_jax():
    """``chip_smoke.py`` and the port's export modules import without JAX,
    flax, optax, orbax or the JAX package (a fresh interpreter), and no
    line of theirs names them."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import py_psnode_tpu_torch.export.native_runtime, py_psnode_tpu_torch.train.variants\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'py_psnode_tpu'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|py_psnode_tpu)\b(?!_torch)", re.M)
    package = REPO / "py_psnode_tpu_torch"
    sources = [REPO / "chip_smoke.py",
               *sorted(p for p in package.rglob("*.py") if "_build" not in p.relative_to(package).parts)]
    assert not [str(p) for p in sources if pattern.search(p.read_text())]
