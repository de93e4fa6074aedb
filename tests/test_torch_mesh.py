"""The port's mesh export (localrf_tpu_torch/utils/mesh.py) against the JAX
package's: marching tetrahedra and the PLY bytes on tests/test_mesh.py's
volumes (the same numpy code: equal exactly), and export_density_ply of a
small field carried across by convert.field_from_jax (face counts equal,
vertices within 1e-4 voxel-relative: the dense alpha agrees to ~4e-6)."""
import numpy as np
import pytest

import jax

from localrf_tpu.models import tensorf as jtf
from localrf_tpu.utils import mesh as jmesh
from localrf_tpu_torch.convert import field_from_jax
from localrf_tpu_torch.models import tensorf as ttf
from localrf_tpu_torch.utils import mesh as tmesh


def _sphere(n: int = 20) -> np.ndarray:
    ax = np.linspace(-1, 1, n)
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    return 1.0 - np.sqrt(x**2 + y**2 + z**2)


@pytest.mark.parametrize("vol", ["sphere", "empty"])
def test_marching_tetrahedra_equals_jax(vol):
    vals = _sphere() if vol == "sphere" else np.zeros((8, 8, 8))
    got, want = tmesh.marching_tetrahedra(vals, 0.5), jmesh.marching_tetrahedra(vals, 0.5)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (len(got[1]) > 100) == (vol == "sphere")


def test_write_ply_bytes_equal_jax(tmp_path):
    verts, faces = jmesh.marching_tetrahedra(_sphere(12), 0.5)
    tmesh.write_ply(str(tmp_path / "port.ply"), verts, faces)
    jmesh.write_ply(str(tmp_path / "jax.ply"), verts, faces)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def _read_ply(path) -> tuple[np.ndarray, np.ndarray]:
    lines = open(path).read().splitlines()
    n_v = int(lines[2].split()[-1])
    n_f = int(lines[6].split()[-1])
    body = lines[9:]
    verts = np.array([[float(t) for t in ln.split()] for ln in body[:n_v]]).reshape(-1, 3)
    faces = np.array([[int(t) for t in ln.split()[1:]] for ln in body[n_v:n_v + n_f]]).reshape(-1, 3)
    return verts, faces


def test_export_density_ply_matches_jax(tmp_path):
    """A random 16x18x20 field (density factors scaled x12 so that alpha
    reaches 0.84) meshed at level 0.5 on a 24x26x28 lattice: the same
    vertex and face counts and faces, the world vertices within 1e-4 of the
    aabb (a vertex moves by the alpha difference over its edge's slope)."""
    kw = dict(grid_size=(16, 18, 20))
    jcfg, tcfg = jtf.TensorfConfig(**kw), ttf.TensorfConfig(**kw)
    params = jax.device_get(jtf.init_tensorf(jax.random.PRNGKey(3), jcfg))
    params = {k: v * 12.0 if k.startswith("density") else v for k, v in params.items()}
    grid = (24, 26, 28)
    want = jmesh.export_density_ply(params, jcfg, str(tmp_path / "jax.ply"), grid_size=grid)
    got = tmesh.export_density_ply(field_from_jax(params, device="cpu"), tcfg, str(tmp_path / "port.ply"),
                                   grid_size=grid)
    assert got == want and got[1] > 100
    gv, gf = _read_ply(tmp_path / "port.ply")
    wv, wf = _read_ply(tmp_path / "jax.ply")
    np.testing.assert_array_equal(gf, wf)
    assert np.abs(gv - wv).max() < 1e-4
