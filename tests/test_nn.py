"""NN ops vs brute-force numpy oracles, with mask correctness."""

import jax.numpy as jnp
import numpy as np

from kss_icp.ops.nn import (
    knn,
    masked_mean_nn_distance,
    masked_mean_nn_sqdist,
    nearest_neighbor,
    pairwise_sqdist,
)


def brute_nn(query, ref):
    d2 = ((query[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    return d2.min(axis=1), d2.argmin(axis=1)


def test_pairwise_sqdist_oracle(rng):
    a = rng.normal(size=(40, 3))
    b = rng.normal(size=(60, 3))
    expected = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    got = np.asarray(pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, expected, atol=1e-10)


def test_nearest_neighbor_oracle(rng):
    q = rng.normal(size=(100, 3))
    r = rng.normal(size=(80, 3))
    d2, idx = nearest_neighbor(jnp.asarray(q), jnp.asarray(r), jnp.ones(80, bool))
    ed2, eidx = brute_nn(q, r)
    np.testing.assert_allclose(np.asarray(d2), ed2, atol=1e-10)
    np.testing.assert_array_equal(np.asarray(idx), eidx)


def test_nearest_neighbor_respects_ref_mask(rng):
    q = rng.normal(size=(30, 3))
    r = rng.normal(size=(50, 3))
    mask = np.zeros(50, bool)
    mask[:20] = True
    d2, idx = nearest_neighbor(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask))
    ed2, eidx = brute_nn(q, r[:20])
    np.testing.assert_allclose(np.asarray(d2), ed2, atol=1e-10)
    np.testing.assert_array_equal(np.asarray(idx), eidx)
    assert np.all(np.asarray(idx) < 20)


def test_nearest_neighbor_chunked_matches(rng):
    q = rng.normal(size=(128, 3))
    r = rng.normal(size=(64, 3))
    mask = jnp.ones(64, bool)
    d2a, ia = nearest_neighbor(jnp.asarray(q), jnp.asarray(r), mask)
    d2b, ib = nearest_neighbor(jnp.asarray(q), jnp.asarray(r), mask, chunk=32)
    np.testing.assert_allclose(np.asarray(d2a), np.asarray(d2b), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


def test_mean_nn_distance_query_mask(rng):
    q = rng.normal(size=(40, 3))
    r = rng.normal(size=(40, 3))
    qmask = np.zeros(40, bool)
    qmask[:25] = True
    got = float(
        masked_mean_nn_distance(
            jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(r), jnp.ones(40, bool)
        )
    )
    ed2, _ = brute_nn(q[:25], r)
    np.testing.assert_allclose(got, np.sqrt(ed2).mean(), rtol=1e-8)


def test_mean_nn_sqdist_is_pcl_fitness(rng):
    q = rng.normal(size=(32, 3))
    r = rng.normal(size=(48, 3))
    got = float(
        masked_mean_nn_sqdist(
            jnp.asarray(q), jnp.ones(32, bool), jnp.asarray(r), jnp.ones(48, bool)
        )
    )
    ed2, _ = brute_nn(q, r)
    np.testing.assert_allclose(got, ed2.mean(), rtol=1e-8)


def test_knn_oracle(rng):
    q = rng.normal(size=(20, 3))
    r = rng.normal(size=(64, 3))
    k = 5
    d2, idx = knn(jnp.asarray(q), jnp.asarray(r), jnp.ones(64, bool), k)
    full = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    expected = np.sort(full, axis=1)[:, :k]
    np.testing.assert_allclose(np.sort(np.asarray(d2), axis=1), expected, atol=1e-10)


def test_knn_streaming_matches_dense(rng):
    # The streaming path (query chunks x reference tiles, running top-k
    # merge) must reproduce the dense path exactly, including masking and
    # non-divisible chunk remainders.
    from kss_icp.ops.nn import knn_streaming

    q = rng.normal(size=(197, 3)).astype(np.float32)
    r = rng.normal(size=(331, 3)).astype(np.float32)
    mask = np.ones(331, bool)
    mask[7] = mask[200] = False
    k = 9
    dd2, didx = knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), k)
    sd2, sidx = knn_streaming(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask), k,
        query_chunk=64, ref_chunk=48,
    )
    # f32 matmul blocking differs between the (Q, R) dense einsum and the
    # per-tile einsums -> 1-ulp noise; compare with an absolute tolerance.
    np.testing.assert_allclose(np.asarray(sd2), np.asarray(dd2),
                               rtol=1e-5, atol=2e-6)
    # Indices may differ only where distances tie; compare via distances.
    full = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    full[:, ~mask] = np.inf
    np.testing.assert_allclose(
        np.take_along_axis(full, np.asarray(sidx), 1), np.asarray(sd2),
        rtol=1e-5, atol=2e-6,
    )


def test_knn_auto_streams_large_cloud():
    # 10^5-point regime (the reference's octree path,
    # ballRegionCompute.hpp:477-530): knn must auto-route to streaming —
    # the dense (P, P) matrix would be 40 GB at 10^5 points — and normals
    # must come out unit-length. Verified against the dense path on a
    # subsample.
    from kss_icp.ops.normals import estimate_normals

    rng2 = np.random.default_rng(7)
    n = 40960  # (n*n = 1.7e9 elements > the 2^25 dense limit)
    u = rng2.uniform(-1, 1, n)
    v = rng2.uniform(-1, 1, n)
    pts = np.stack([u, v, 0.3 * np.sin(3 * u) * np.cos(2 * v)], -1).astype(np.float32)
    mask = np.ones(n, bool)
    d2, idx = knn(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(mask), 12)
    assert d2.shape == (n, 12)
    # Subsample cross-check vs the dense path on the same reference cloud.
    sub = np.arange(0, n, 512)
    dd2, _ = knn(
        jnp.asarray(pts[sub]), jnp.asarray(pts[:16384]),
        jnp.asarray(mask[:16384]), 12,
    )
    sd2, _ = knn(
        jnp.asarray(pts[sub]), jnp.asarray(pts[:16384]),
        jnp.asarray(mask[:16384]), 12, query_chunk=32, ref_chunk=4096,
    )
    np.testing.assert_allclose(np.asarray(sd2), np.asarray(dd2), atol=1e-5)
    normals = estimate_normals(jnp.asarray(pts), jnp.asarray(mask))
    lens = np.linalg.norm(np.asarray(normals), axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)


class TestTrimmedOps:
    """Overlap-mode robust statistics (ops/nn.py, round 4)."""

    def test_trimmed_masked_mean_basic(self):
        import jax.numpy as jnp

        from kss_icp.ops.nn import trimmed_masked_mean

        v = jnp.asarray([5.0, 1.0, 3.0, 2.0, 100.0, 4.0])
        m = jnp.asarray([True] * 6)
        # q=0.5 -> k=3 smallest of 6 = mean(1,2,3)
        assert float(trimmed_masked_mean(v, m, 0.5)) == 2.0
        # q=1.0 -> all
        np.testing.assert_allclose(
            float(trimmed_masked_mean(v, m, 1.0)), np.mean([1, 2, 3, 4, 5, 100]))

    def test_trimmed_masked_mean_ignores_invalid(self):
        import jax.numpy as jnp

        from kss_icp.ops.nn import trimmed_masked_mean

        v = jnp.asarray([0.001, 9.0, 1.0, 3.0, 2.0])
        m = jnp.asarray([False, True, True, True, True])  # 4 valid
        # k = floor(0.5*4)=2 -> mean(1,2); the masked 0.001 must not leak in
        assert float(trimmed_masked_mean(v, m, 0.5)) == 1.5

    def test_masked_quantile_threshold(self):
        import jax.numpy as jnp

        from kss_icp.ops.nn import masked_quantile_threshold

        v = jnp.asarray([4.0, 1.0, 3.0, 2.0])
        m = jnp.ones(4, bool)
        assert float(masked_quantile_threshold(v, m, 0.5)) == 2.0
        assert float(masked_quantile_threshold(v, m, 1.0)) == 4.0
        # batched + masked; rank = ceil(q * n_valid) (ADVICE r4: a float32
        # cast-truncation dropped one element at fractional products —
        # ceil(0.67*4) = 3, ceil(0.67*3) = 3).
        vb = jnp.stack([v, jnp.asarray([10.0, 20.0, 30.0, 1e30])])
        mb = jnp.asarray([[True] * 4, [True, True, True, False]])
        out = masked_quantile_threshold(vb, mb, 0.67)
        np.testing.assert_allclose(np.asarray(out), [3.0, 30.0])
        # Exact-integer products must not lose an element to f32 rounding
        # (0.5 * 4 = 2 exactly, whatever the platform).
        assert float(masked_quantile_threshold(v, m, 0.25)) == 1.0

    def test_trim_metric_prefers_overlap_alignment(self, rng):
        """The 'trim' field metric scores a correct partial alignment below
        a slid one even when 'ave' ties or inverts (the overlap-mode
        design premise)."""
        import jax.numpy as jnp

        from kss_icp.ops.nn import masked_nn_error

        # target: segment [0, 10]; source: crop [0, 7] of the same curve
        t = np.linspace(0, 10, 400)
        tgt = np.stack([t, np.sin(t), np.zeros_like(t)], -1)
        s = np.linspace(0, 7, 280)
        src = np.stack([s, np.sin(s), np.zeros_like(s)], -1).astype(np.float32)
        tm = jnp.ones(400, bool)
        sm = jnp.ones(280, bool)
        correct = jnp.asarray(src)
        slid = jnp.asarray(src + np.array([1.5, 0, 0], np.float32))
        e_corr = float(masked_nn_error(correct, sm, jnp.asarray(tgt, jnp.float32),
                                       tm, metric="trim", trim_fraction=0.7))
        e_slid = float(masked_nn_error(slid, sm, jnp.asarray(tgt, jnp.float32),
                                       tm, metric="trim", trim_fraction=0.7))
        assert e_corr < e_slid

    def test_trimmed_icp_recovers_partial_transform(self, rng):
        """Trimmed ICP converges on a 70%-overlap pair where the crop's
        far points would otherwise drag the Kabsch update."""
        import jax.numpy as jnp

        from kss_icp.models.icp import ICPParams, icp
        from kss_icp.config import KSSICPConfig

        t = rng.uniform(-1, 1, (600, 2))
        surf = np.concatenate(
            [t, (0.3 * np.sin(2 * t[:, :1]) * np.cos(3 * t[:, 1:2]))], -1
        ).astype(np.float32)
        # source = points with x <= 0.4 (keep ~70%), small rigid offset
        src = surf[surf[:, 0] <= 0.4]
        ang = 0.12
        c, s = np.cos(ang), np.sin(ang)
        r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        src_moved = (src @ r.T + np.array([0.05, -0.03, 0.02], np.float32))
        p = 512
        sp = np.zeros((p, 3), np.float32)
        sp[: len(src_moved)] = src_moved
        smk = np.zeros(p, bool)
        smk[: len(src_moved)] = True
        params = ICPParams.from_config(KSSICPConfig(), jnp.float32)
        res = icp(jnp.asarray(sp), jnp.asarray(smk),
                  jnp.asarray(surf), jnp.ones(len(surf), bool), params,
                  trim_fraction=0.8)
        # recovered rotation ~ r^T
        err = np.abs(np.asarray(res.rotation) @ r - np.eye(3)).max()
        assert err < 0.02, err
        assert float(res.fitness) < 1e-4
