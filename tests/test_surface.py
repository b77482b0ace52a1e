"""Tests for SASA, Voronoi, and isosurface mesh components."""

import numpy as np
import jax.numpy as jnp

from waterorderlib_tpu.surface import sasa, voronoi, mesh
from waterorderlib_tpu.io.synthetic import make_water_box


def test_sasa_isolated_atom():
    # a lone sphere is fully exposed: area = 4 pi r^2
    pos = jnp.array([[0.0, 0.0, 0.0]])
    radii = jnp.array([2.0])
    areas, exposed = sasa.sasa_per_atom(pos, radii - 1.4, probe_radius=1.4, n_points=500)
    assert np.isclose(float(areas[0]), 4 * np.pi * 4.0, rtol=1e-3)
    assert bool(exposed[0])


def test_sasa_buried_atom():
    # center atom fully enclosed by a big sphere shell: zero exposed area
    shell = jnp.asarray(
        np.array(
            [p for p in 3.0 * np.asarray(mesh_points_icosahedral())], np.float32
        )
    )
    pos = jnp.concatenate([jnp.zeros((1, 3)), shell])
    radii = jnp.concatenate([jnp.array([1.0]), 2.5 * jnp.ones(shell.shape[0])])
    pts = jnp.asarray(np.asarray(sasa.sphere_points(200)), jnp.float32) if hasattr(sasa, "sphere_points") else None
    areas, exposed = sasa.sasa_per_atom(pos, radii, probe_radius=0.0, n_points=200)
    assert float(areas[0]) == 0.0
    assert not bool(exposed[0])


def mesh_points_icosahedral():
    from waterorderlib_tpu.core.geometry import sphere_points

    return sphere_points(30)


def test_sasa_two_touching_spheres_symmetry():
    pos = jnp.array([[0.0, 0.0, 0.0], [2.5, 0.0, 0.0]])
    radii = jnp.array([1.5, 1.5])
    areas, _ = sasa.sasa_per_atom(pos, radii, probe_radius=0.0, n_points=1000)
    a = np.asarray(areas)
    # the golden spiral is not mirror-symmetric, so counts differ slightly
    assert np.isclose(a[0], a[1], rtol=0.05)
    assert a[0] < 4 * np.pi * 1.5**2  # partially occluded


def test_sasa_topk_matches_brute():
    """The occluder-pruned sweep must be bit-identical to the brute sweep
    whenever its certificate holds, and sasa_per_atom must fall back to the
    brute result when K is too small."""
    from waterorderlib_tpu.core.geometry import sphere_points

    top, traj = make_water_box(64, n_frames=1, seed=5, solute_elements=["C", "O"])
    pos = jnp.asarray(traj.positions[0])
    box = jnp.asarray(traj.boxes[0])
    n = pos.shape[0]
    rs = np.random.RandomState(2)
    radii = jnp.asarray(1.2 + 1.4 + 0.6 * rs.random(n), jnp.float32)
    pts = jnp.asarray(sphere_points(300), jnp.float32)

    a_brute, e_brute = sasa.sphere_surface_areas(pos, radii, pts, box)
    a_topk, e_topk, ok = sasa.sphere_surface_areas_topk(pos, radii, pts, box, k=128)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(a_topk), np.asarray(a_brute))
    np.testing.assert_array_equal(np.asarray(e_topk), np.asarray(e_brute))

    # k too small: certificate must fail on this dense box...
    _, _, ok_small = sasa.sphere_surface_areas_topk(pos, radii, pts, box, k=4)
    assert not bool(ok_small)
    # ...and the public wrapper must still return the brute-exact answer
    a_pub, e_pub = sasa.sasa_per_atom(pos, radii - 1.4, box=box, probe_radius=1.4, n_points=300)
    np.testing.assert_array_equal(np.asarray(a_pub), np.asarray(a_brute))


def test_sphere_volumes_partition():
    pos = jnp.array([[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]])
    radii = jnp.array([1.0, 1.0])
    vols = np.asarray(sasa.sphere_volumes(pos, radii, 0.2, grid_points_per_axis=96))
    want = 4.0 / 3.0 * np.pi
    np.testing.assert_allclose(vols, want, rtol=0.1)


def test_voronoi_volumes_cubic_lattice():
    # 27 points on a cubic lattice with spacing 3: interior cells are 3^3 cubes
    s = 3.0
    grid = np.arange(3) * s + s / 2
    pts = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), -1).reshape(-1, 3)
    box_l = 9.0
    vol, area = voronoi.voronoi_volumes(pts, box_l, len(pts))
    np.testing.assert_allclose(vol, s**3, rtol=1e-6)
    np.testing.assert_allclose(area, 6 * s * s, rtol=1e-6)


def test_voronoi_contacts_lattice():
    s = 3.0
    grid = np.arange(3) * s + s / 2
    pts = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), -1).reshape(-1, 3)
    contacts, atom_area, wat_area, atom_vol = voronoi.voronoi_contacts(pts, 9.0, len(pts))
    # center point (index 13) touches its 6 face neighbors with s*s... but
    # reference-style hull.area of a flat polygon counts both sides (2x)
    center = 13
    touching = np.where(contacts[center] > 0)[0]
    assert len(touching) == 6
    np.testing.assert_allclose(contacts[center][touching], 2 * s * s, rtol=1e-5)
    np.testing.assert_allclose(atom_vol[0], s**3, rtol=1e-6)


def test_voronoi_closed_form_matches_hulls():
    """The vectorized pyramid-decomposition volumes/areas/contacts must agree
    with reference-style per-region ConvexHull('QJ') evaluation to the hull
    joggle noise on a random (non-lattice) box."""
    from scipy.spatial import ConvexHull, Voronoi

    top, traj = make_water_box(64, n_frames=1, seed=9)
    pos = traj.positions[0].astype(float)
    box_l = float(traj.boxes[0][0])
    num = len(pos)

    vol_f, area_f = voronoi.voronoi_volumes(pos, box_l, num)
    c_f, aa_f, wa_f, av_f = voronoi.voronoi_contacts(pos, box_l, num)

    v = Voronoi(voronoi.mirror_points(pos, box_l))
    regions = [np.array(v.regions[v.point_region[i]]) for i in range(num)]
    vol_h = np.zeros(num)
    area_h = np.zeros(num)
    c_h = np.zeros((num, num))
    for i in range(num):
        h = ConvexHull(v.vertices[regions[i]], qhull_options="QJ")
        vol_h[i] = h.volume
        area_h[i] = h.area
        for j in range(i + 1, num):
            co = np.intersect1d(regions[i], regions[j])
            if len(co) >= 3:
                if len(co) >= 4:
                    fa = ConvexHull(v.vertices[co], qhull_options="QJ").area
                else:
                    a, b, c = v.vertices[co]
                    fa = 0.5 * float(np.linalg.norm(np.cross(b - a, c - a)))
                c_h[i, j] = c_h[j, i] = fa
    np.testing.assert_allclose(vol_f, vol_h, rtol=1e-7)
    np.testing.assert_allclose(area_f, area_h, rtol=1e-7)
    np.testing.assert_allclose(av_f[0], vol_h, rtol=1e-7)
    np.testing.assert_allclose(aa_f[0], area_h, rtol=1e-7)
    nz = c_h > 0
    assert np.array_equal(c_f > 0, nz)
    np.testing.assert_allclose(c_f[nz], c_h[nz], rtol=1e-6)
    # total cell volume of a certified tessellation tiles the box
    np.testing.assert_allclose(vol_f.sum(), box_l**3, rtol=1e-9)


def test_marching_tetrahedra_sphere():
    # field = distance from center; isosurface at r=5 is a sphere
    n = 24
    ax = np.linspace(-8, 8, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = np.sqrt(X**2 + Y**2 + Z**2)
    sp = ax[1] - ax[0]
    verts, faces = mesh.marching_tetrahedra(vol, 5.0, spacing=(sp, sp, sp), origin=(-8, -8, -8))
    assert len(verts) > 100 and len(faces) > 100
    r = np.linalg.norm(verts, axis=1)
    np.testing.assert_allclose(r, 5.0, atol=0.35)
    area = mesh.mesh_area(verts, faces)
    np.testing.assert_allclose(area, 4 * np.pi * 25, rtol=0.1)


def test_triangle_utils():
    tri = np.array([[0.0, 0, 0], [3.0, 0, 0], [0.0, 4.0, 0]])
    assert np.isclose(float(mesh.triangle_area(tri)), 6.0)
    t2d = np.asarray(mesh.transform_triangle(tri))
    np.testing.assert_allclose(t2d[0], [0, 0], atol=1e-6)
    np.testing.assert_allclose(t2d[1], [3, 0], atol=1e-6)
    np.testing.assert_allclose(t2d[2], [0, 4], atol=1e-6)
    assert np.isclose(float(mesh.property_barycentric(np.array([1.0, 2.0, 3.0]))), 2.0)


def test_gaussian_curvature_flat_interior():
    # flat grid mesh: interior vertices have ~zero angle defect
    n = 5
    xs, ys = np.meshgrid(np.arange(n, dtype=float), np.arange(n, dtype=float))
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(n * n)], axis=1)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            faces.append([a, a + 1, a + n])
            faces.append([a + 1, a + n + 1, a + n])
    k = mesh.gaussian_curvature(verts, np.array(faces))
    interior = verts[:, 0].astype(int) % n != 0
    center = 2 * n + 2
    assert abs(k[center]) < 1e-9


def test_vdw_assign_and_get_bonds():
    top, _ = make_water_box(2, solute_elements=["C", "O", "S", "N"], seed=1)
    vdw, names = voronoi.vdw_assign(top)
    assert names == ["C", "O", "S", "N"]
    assert vdw == [1.70, 1.52, 1.80, 1.55]
    sol_inds = np.where(top.res_names == "MOL")[0]
    numC, numO, numN, numS = voronoi.get_bonds(top, sol_inds)
    # chain C-O-S-N: C has 1 O partner; O has C+S...
    assert numO[0, 0] == 1  # C bonded to O
    assert numC[0, 1] == 1 and numS[0, 1] == 1  # O bonded to C and S


def test_local_connections():
    conn = np.array([[0, 1.0, 0], [1.0, 0, 2.0], [0, 2.0, 0]])
    names = ["C", "O", "S"]
    conn_num, nC, nO, nN, nS, phob = voronoi.local_connections(conn, names)
    assert conn_num[0, 1] == 2
    # neighborhood of atom 1 = {C, S, itself O}
    assert nC[0, 1] == 1 and nS[0, 1] == 1 and nO[0, 1] == 1


def test_sasa_pruned_sweep_matches_brute():
    """sasa_per_atom serves the occluder-pruned sweep when its certificate
    holds; it must equal the brute all-occluder sweep exactly."""
    from waterorderlib_tpu.core.geometry import sphere_points
    from waterorderlib_tpu.io.synthetic import water_oxygen_lattice

    n = 300
    box_l = (n / 0.033456) ** (1.0 / 3.0)
    pos = jnp.asarray(water_oxygen_lattice(n, box_l, seed=2), jnp.float32)
    radii = jnp.full((n,), 1.5, jnp.float32)
    box = jnp.asarray([box_l] * 3, jnp.float32)
    areas, exposed = sasa.sasa_per_atom(pos, radii, box, n_points=240)
    pts = jnp.asarray(sphere_points(240), jnp.float32)
    a_ref, e_ref = sasa.sphere_surface_areas(pos, radii + 1.4, pts, box, 10)
    np.testing.assert_array_equal(np.asarray(areas), np.asarray(a_ref))
    np.testing.assert_array_equal(np.asarray(exposed), np.asarray(e_ref))
