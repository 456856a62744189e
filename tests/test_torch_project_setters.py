"""Port parity: the Project setters of dbat_tpu_torch (core/project.py,
the reference's misc/ layer) and prune_network against dbat_tpu's.

Each case builds one self-calibrating ring network in the JAX package,
copies it into the port, applies the same setter calls to both and
holds the two projects equal with the port's compare_projects at rtol
0 and atol 0.  The control-point and EO tables are written once to
tmp_path and read by each package's own loader."""

import numpy as np
import pytest

from dbat_tpu.core.project import prune_network as jprune
from dbat_tpu.io.cpt import load_cpt as jload_cpt
from dbat_tpu.io.eotable import load_eo_table as jload_eo
from dbat_tpu.pipeline.synthetic import make_ring_network as jmake
from dbat_tpu.pipeline.synthetic import perturb as jperturb
from dbat_tpu_torch.core.compare import compare_projects
from dbat_tpu_torch.core.project import prune_network as tprune
from dbat_tpu_torch.io.cpt import load_cpt as tload_cpt
from dbat_tpu_torch.io.eotable import load_eo_table as tload_eo
from port_shared import port_project

NET = dict(n_img=8, n_pt=80, rays_per_pt=(2, 6), n_obs_target=320,
           n_ctrl=5, noise_px=0.1, est_io_cols=("cc", "px", "py"), seed=9)


def _pair(**kw):
    j = jmake(**{**NET, **kw})
    jperturb(j, seed=3)
    return j, port_project(j)


def _equal(t, j):
    assert compare_projects(t, j, rtol=0, atol=0) == []


def _both(t, j, fn):
    fn(t)
    fn(j)
    _equal(t, j)


def test_copy_is_deep():
    j, t = _pair()
    c = t.copy()
    _equal(c, j)
    c.io[0, 0] += 1.0
    c.op_labels[0] = "changed"
    _equal(t, j)


@pytest.mark.parametrize("cams", [None, [1, 4]])
def test_camera_values(cams):
    j, t = _pair()
    _both(t, j, lambda p: p.set_cam_vals_default(6.5, cams=cams))
    _both(t, j, lambda p: p.prior_io_val.__setitem__(
        (slice(None), 0), 7.25))
    _both(t, j, lambda p: p.set_cam_vals_loaded(cams=cams))


@pytest.mark.parametrize("name", ["cc", "px", "py", "as", "sk", "pp", "lin",
                                  "K", "P", "af", "all", "K1", "K3", "P2"])
def test_io_parameter_groups(name):
    j, t = _pair()
    assert t._io_param_indices(name) == j._io_param_indices(name)


@pytest.mark.parametrize("name", ["K4", "P3", "K0", "xx"])
def test_io_parameter_errors(name):
    j, t = _pair()
    for p in (t, j):
        with pytest.raises(ValueError):
            p._io_param_indices(name)


@pytest.mark.parametrize("model", [1, 3])
def test_camera_estimation(model):
    j, t = _pair()
    j.dist_model = t.dist_model = model
    _both(t, j, lambda p: p.set_cam_est("all", "not", "sk", cams=[0, 2]))
    _both(t, j, lambda p: p.set_cam_est("K", "P1", "as"))
    _both(t, j, lambda p: p.set_cam_est("not", "P"))
    assert t.est_io[:, 3].any() == (model >= 3)


def test_eo_estimation():
    j, t = _pair()
    _both(t, j, lambda p: p.set_eo_est("none", cams=[1]))
    _both(t, j, lambda p: p.set_eo_est("pos", "not", "ka", "x",
                                       cams=[0, 5]))
    _both(t, j, lambda p: p.set_eo_est("ang", cams=[6]))
    _both(t, j, lambda p: p.set_eo_est_depend(2))
    assert not t.est_eo[2].any() and (~t.est_eo).sum() == 7


def test_clear_eo_and_op():
    j, t = _pair()
    _both(t, j, lambda p: p.prior_eo_use.__setitem__((3, slice(0, 3)), True))
    _both(t, j, lambda p: p.prior_op_use.__setitem__((7, 1), True))
    _both(t, j, lambda p: p.clear_eo())
    _both(t, j, lambda p: p.clear_op())
    assert np.isfinite(t.eo[3, :3]).all() and np.isnan(t.eo[3, 3:]).all()
    assert np.isfinite(t.op[:NET["n_ctrl"]]).all()
    assert np.isfinite(t.op[7, 1]) and np.isnan(t.op[7, 0])


def _write_cpt(tmp_path, j):
    """Points 3 and 4 (ids 4, 5) as control points with stds, point 7
    (id 8) exact, a point no image sees (id 999), labels."""
    rows = [f"4,north,{j.op[3, 0]:.17g},{j.op[3, 1]:.17g},{j.op[3, 2]:.17g},"
            "0.01,0.02",
            f"5,,{j.op[4, 0]:.17g},{j.op[4, 1]:.17g},{j.op[4, 2]:.17g},0.03",
            f"8,east,{j.op[7, 0]:.17g},{j.op[7, 1]:.17g},{j.op[7, 2]:.17g}",
            "999,far,1,2,3"]
    path = tmp_path / "cpt.txt"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.mark.parametrize("match", ["auto", "id", "label", "both"])
def test_match_and_set_control_points(tmp_path, match):
    j, t = _pair()
    j.is_ctrl[7] = t.is_ctrl[7] = True
    path = _write_cpt(tmp_path, j)
    jt, tt = jload_cpt(path), tload_cpt(path)
    i_t, k_t = t.match_cpt(tt, match)
    i_j, k_j = j.match_cpt(jt, match)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(k_t, k_j)
    t.set_cpt(tt, i_t, k_t, is_ctrl=True)
    j.set_cpt(jt, i_j, k_j, is_ctrl=True)
    _equal(t, j)


def test_set_check_points(tmp_path):
    j, t = _pair()
    path = _write_cpt(tmp_path, j)
    jt, tt = jload_cpt(path), tload_cpt(path)
    i = np.array([10, 11])
    t.set_cpt(tt, i, np.array([0, 2]), is_ctrl=False)
    j.set_cpt(jt, i, np.array([0, 2]), is_ctrl=False)
    _equal(t, j)
    assert t.is_check[10] and t.est_op[11].all()


@pytest.mark.parametrize("match", ["auto", "id", "label"])
def test_match_and_set_prior_eo(tmp_path, match):
    j, t = _pair()
    rows = ["# id,label,x,y,z,sx,sy,sz,omega,phi,kappa,so,sp,sk"]
    for i in (1, 4, 6):
        ang = j.eo[i, 3:6] * 180 / np.pi
        std = "0,0,0" if i == 4 else "0.05,0.05,0.1"
        rows.append(f"{i + 1},{j.img_labels[i]},"
                    + ",".join(f"{v:.17g}" for v in j.eo[i, :3])
                    + f",{std}," + ",".join(f"{v:.17g}" for v in ang)
                    + ",0.1,0.1,0.2")
    rows.append("99,nowhere.jpg,0,0,0,1,1,1,0,0,0,1,1,1")
    path = tmp_path / "eo.txt"
    path.write_text("\n".join(rows) + "\n")
    fmt = rows[0][2:]
    jt, tt = jload_eo(str(path), fmt), tload_eo(str(path), fmt)
    i_t, k_t = t.match_eo(tt, match)
    i_j, k_j = j.match_eo(jt, match)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_array_equal(k_t, k_j)
    assert len(i_t) == 3
    t.set_prior_eo(tt, i_t, k_t)
    j.set_prior_eo(jt, i_j, k_j)
    _equal(t, j)


@pytest.mark.parametrize("min_views", [2, 3])
def test_prune_network(min_views):
    j, t = _pair()
    keep = np.random.default_rng(4).uniform(size=j.n_obs) > 0.3
    st, sj = tprune(t, keep_obs=keep, min_views=min_views), \
        jprune(j, keep_obs=keep, min_views=min_views)
    assert st["n_obs_removed"] == sj["n_obs_removed"] > 0
    assert st["n_op_removed"] == sj["n_op_removed"] > 0
    np.testing.assert_array_equal(st["op_keep"], sj["op_keep"])
    _equal(t, j)
    assert t.is_ctrl[:NET["n_ctrl"]].all()


def test_prune_network_keeps_everything_by_default():
    j, t = _pair()
    st, sj = tprune(t), jprune(j)
    assert st["n_obs_removed"] == sj["n_obs_removed"]
    _equal(t, j)
