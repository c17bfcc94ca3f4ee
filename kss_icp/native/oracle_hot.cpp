// Native (C++) implementation of the CPU oracle's two hot loops, used ONLY
// to calibrate the measured-baseline denominator (VERDICT round-2 item #5):
// the Python oracle (kss_icp/oracle.py) drives its rotation scan and
// multi-start ICP from Python around C-speed k-d queries, so its wall time
// over-estimates what a native build of the reference would take. Compiling
// the same loops in C++ bounds that overhead from below:
//
//   * rotation_scan — initRegistrationKSS.hpp:222-296: cumulative-axis
//     Euler triple loop over [0, 6.3) in 6.3/step increments (float
//     accumulation quirk reproduced: step=8 visits 9 angles/axis), error =
//     mean 1-NN distance against a k-d tree of the target (:430-450).
//   * icp_native — pcl::IterativeClosestPoint 1.8 semantics with the
//     reference's settings (KSS_ICP.hpp:156-159): 1-NN correspondences
//     rejected over maxCorrDist, Umeyama/SVD rigid estimation,
//     DefaultConvergenceCriteria (translation^2 <= eps, cos(angle) >=
//     1-eps, relative + absolute correspondence-MSE deltas).
//
// Points are float32 (the PCL model — pcl::PointXYZ clouds and Matrix4f
// transforms); reductions accumulate in double. The k-d tree is a static
// median-split tree (FLANN's role). Serial on purpose: the reference's
// registration hot path is single-threaded (SURVEY.md §2.3 — its OpenMP
// sites don't touch the rotation scan or ICP).
//
// NOT part of the production path. See native/oracle_hot.py (ctypes)
// and scripts/calibrate_oracle.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct KDNode {
  float split;
  int axis;       // -1 => leaf
  int left, right;   // children (internal) or [begin,end) range (leaf)
};

struct KDTree {
  std::vector<float> pts;      // (n, 3) reordered
  std::vector<int> orig;       // reordered index -> original index
  std::vector<KDNode> nodes;
  int root = -1;

  int build(std::vector<int>& idx, const float* p, int begin, int end) {
    KDNode node;
    if (end - begin <= 8) {
      node.axis = -1;
      node.left = begin;
      node.right = end;
      nodes.push_back(node);
      return static_cast<int>(nodes.size()) - 1;
    }
    float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = begin; i < end; ++i) {
      const float* q = p + 3 * idx[i];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], q[a]);
        hi[a] = std::max(hi[a], q[a]);
      }
    }
    int axis = 0;
    for (int a = 1; a < 3; ++a)
      if (hi[a] - lo[a] > hi[axis] - lo[axis]) axis = a;
    int mid = (begin + end) / 2;
    std::nth_element(idx.begin() + begin, idx.begin() + mid, idx.begin() + end,
                     [&](int a, int b) { return p[3 * a + axis] < p[3 * b + axis]; });
    node.axis = axis;
    node.split = p[3 * idx[mid] + axis];
    int self = static_cast<int>(nodes.size());
    nodes.push_back(node);
    int l = build(idx, p, begin, mid);
    int r = build(idx, p, mid, end);
    nodes[self].left = l;
    nodes[self].right = r;
    return self;
  }

  void init(const float* p, int n) {
    std::vector<int> idx(n);
    for (int i = 0; i < n; ++i) idx[i] = i;
    nodes.reserve(2 * n / 8 + 4);
    root = build(idx, p, 0, n);
    pts.resize(3 * static_cast<size_t>(n));
    orig = idx;
    for (int i = 0; i < n; ++i) std::memcpy(&pts[3 * i], p + 3 * idx[i], 12);
  }

  void query(const float* q, int node_i, float& best_d2, int& best_i) const {
    const KDNode& nd = nodes[node_i];
    if (nd.axis < 0) {
      for (int i = nd.left; i < nd.right; ++i) {
        const float* r = &pts[3 * i];
        float dx = q[0] - r[0], dy = q[1] - r[1], dz = q[2] - r[2];
        float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best_d2) {
          best_d2 = d2;
          best_i = i;
        }
      }
      return;
    }
    float diff = q[nd.axis] - nd.split;
    int near = diff < 0.f ? nd.left : nd.right;
    int far = diff < 0.f ? nd.right : nd.left;
    query(q, near, best_d2, best_i);
    if (diff * diff < best_d2) query(q, far, best_d2, best_i);
  }

  inline int nearest(const float* q, float* d2_out) const {
    float best_d2 = 1e30f;
    int best_i = -1;
    query(q, root, best_d2, best_i);
    *d2_out = best_d2;
    return best_i;   // reordered index; pts[3*best_i] are its coords
  }
};

// Single-axis rotations, initRegistration_Transfer semantics
// (initRegistrationKSS.hpp:365-404).
inline void rot_axis1(float c, float s, const float* in, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    float y = in[3 * i + 1], z = in[3 * i + 2];
    out[3 * i + 0] = in[3 * i + 0];
    out[3 * i + 1] = y * c - z * s;
    out[3 * i + 2] = y * s + z * c;
  }
}
inline void rot_axis2(float c, float s, const float* in, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    float x = in[3 * i + 0], z = in[3 * i + 2];
    out[3 * i + 0] = z * s + x * c;
    out[3 * i + 1] = in[3 * i + 1];
    out[3 * i + 2] = z * c - x * s;
  }
}
inline void rot_axis3(float c, float s, const float* in, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    float x = in[3 * i + 0], y = in[3 * i + 1];
    out[3 * i + 0] = x * c - y * s;
    out[3 * i + 1] = x * s + y * c;
    out[3 * i + 2] = in[3 * i + 2];
  }
}

// One-sided Jacobi SVD of a 3x3 (row-major) matrix: A = U diag(s) V^T.
void svd3(const double a_in[9], double u[9], double s[3], double v[9]) {
  double a[9];
  std::memcpy(a, a_in, sizeof(a));
  // v = I
  for (int i = 0; i < 9; ++i) v[i] = (i % 4 == 0) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 30; ++sweep) {
    double off = 0.0;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        // columns p, q of a
        double app = 0, aqq = 0, apq = 0;
        for (int i = 0; i < 3; ++i) {
          app += a[3 * i + p] * a[3 * i + p];
          aqq += a[3 * i + q] * a[3 * i + q];
          apq += a[3 * i + p] * a[3 * i + q];
        }
        off += apq * apq;
        if (std::fabs(apq) < 1e-15 * std::sqrt(app * aqq) + 1e-300) continue;
        double tau = (aqq - app) / (2.0 * apq);
        double t = (tau >= 0 ? 1.0 : -1.0) /
                   (std::fabs(tau) + std::sqrt(1.0 + tau * tau));
        double c = 1.0 / std::sqrt(1.0 + t * t);
        double sn = c * t;
        for (int i = 0; i < 3; ++i) {
          double aip = a[3 * i + p], aiq = a[3 * i + q];
          a[3 * i + p] = c * aip - sn * aiq;
          a[3 * i + q] = sn * aip + c * aiq;
          double vip = v[3 * i + p], viq = v[3 * i + q];
          v[3 * i + p] = c * vip - sn * viq;
          v[3 * i + q] = sn * vip + c * viq;
        }
      }
    }
    if (off < 1e-28) break;
  }
  for (int j = 0; j < 3; ++j) {
    double norm = 0;
    for (int i = 0; i < 3; ++i) norm += a[3 * i + j] * a[3 * i + j];
    norm = std::sqrt(norm);
    s[j] = norm;
    double inv = norm > 1e-300 ? 1.0 / norm : 0.0;
    for (int i = 0; i < 3; ++i) u[3 * i + j] = a[3 * i + j] * inv;
  }
}

}  // namespace

extern "C" {

void* kssicp_kd_build(const float* pts, int n) {
  KDTree* t = new KDTree();
  t->init(pts, n);
  return t;
}

void kssicp_kd_free(void* tree) { delete static_cast<KDTree*>(tree); }

// Mean 1-NN distance of `pts` against the tree (initRegistration_Error_Ave).
double kssicp_mean_nn(void* tree, const float* pts, int n) {
  const KDTree* t = static_cast<KDTree*>(tree);
  double sum = 0.0;
  float d2;
  for (int i = 0; i < n; ++i) {
    t->nearest(pts + 3 * i, &d2);
    sum += std::sqrt(static_cast<double>(d2));
  }
  return sum / n;
}

// The cumulative-axis rotation scan (initRegistrationKSS.hpp:222-296).
// field_out must hold at least ceil(6.3/(6.3/step)+1)^3 doubles; returns the
// per-axis angle count n (field is n*n*n, row-major [i][j][k]).
int kssicp_rotation_scan(const float* src, int ns, void* tree, double step,
                         double* field_out) {
  const KDTree* t = static_cast<KDTree*>(tree);
  double inc = 6.3 / step;
  std::vector<double> angles;
  for (double a = 0.0; a < 6.3; a += inc) angles.push_back(a);
  int n = static_cast<int>(angles.size());
  std::vector<float> ps_x(3 * ns), ps_xy(3 * ns), ps_xyz(3 * ns);
  for (int i = 0; i < n; ++i) {
    float ci = std::cos(static_cast<float>(angles[i]));
    float si = std::sin(static_cast<float>(angles[i]));
    rot_axis1(ci, si, src, ps_x.data(), ns);
    for (int j = 0; j < n; ++j) {
      float cj = std::cos(static_cast<float>(angles[j]));
      float sj = std::sin(static_cast<float>(angles[j]));
      rot_axis2(cj, sj, ps_x.data(), ps_xy.data(), ns);
      for (int k = 0; k < n; ++k) {
        float ck = std::cos(static_cast<float>(angles[k]));
        float sk = std::sin(static_cast<float>(angles[k]));
        rot_axis3(ck, sk, ps_xy.data(), ps_xyz.data(), ns);
        field_out[(i * n + j) * n + k] =
            kssicp_mean_nn(const_cast<KDTree*>(t) /* const method */,
                           ps_xyz.data(), ns);
      }
    }
  }
  return n;
}

// pcl::IterativeClosestPoint 1.8 with the reference's settings.
// Returns iteration count; writes the final 4x4 (row-major, double) and the
// fitness (mean squared 1-NN distance of the transformed source).
int kssicp_icp(const float* src, int ns, void* tree, int max_iterations,
               double max_corr_dist, double transformation_epsilon,
               double euclidean_fitness_epsilon, double* final_out,
               double* fitness_out, int* converged_out) {
  const KDTree* t = static_cast<KDTree*>(tree);
  double final_m[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  std::vector<float> cur(src, src + 3 * static_cast<size_t>(ns));
  double prev_mse = 1.7976931348623157e308;
  const double mse_abs = 1e-12;
  const double rot_thresh = 1.0 - transformation_epsilon;
  const double max_d2 = max_corr_dist * max_corr_dist;
  int it = 0;
  int converged = 0;
  std::vector<int> nn(ns);
  std::vector<float> nn_d2(ns);
  while (true) {
    int kept = 0;
    double mp[3] = {0, 0, 0}, mq[3] = {0, 0, 0};
    for (int i = 0; i < ns; ++i) {
      float d2;
      nn[i] = t->nearest(&cur[3 * i], &d2);
      nn_d2[i] = d2;
      if (d2 <= max_d2) {
        ++kept;
        for (int a = 0; a < 3; ++a) {
          mp[a] += cur[3 * i + a];
          mq[a] += t->pts[3 * nn[i] + a];
        }
      }
    }
    if (kept < 3) break;  // min_number_correspondences_
    for (int a = 0; a < 3; ++a) {
      mp[a] /= kept;
      mq[a] /= kept;
    }
    // H = (p - mp)^T (q - mq) over kept correspondences.
    double h[9] = {0};
    double mse_sum = 0.0;
    for (int i = 0; i < ns; ++i) {
      if (nn_d2[i] > max_d2) continue;
      mse_sum += nn_d2[i];
      double dp[3], dq[3];
      for (int a = 0; a < 3; ++a) {
        dp[a] = cur[3 * i + a] - mp[a];
        dq[a] = t->pts[3 * nn[i] + a] - mq[a];
      }
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) h[3 * r + c] += dp[r] * dq[c];
    }
    double u[9], s[3], v[9];
    svd3(h, u, s, v);
    // rot = V * diag(1,1,sign(det(V U^T))) * U^T  (oracle.py / Umeyama).
    double vut[9] = {0};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        for (int k = 0; k < 3; ++k) vut[3 * r + c] += v[3 * r + k] * u[3 * c + k];
    double det = vut[0] * (vut[4] * vut[8] - vut[5] * vut[7]) -
                 vut[1] * (vut[3] * vut[8] - vut[5] * vut[6]) +
                 vut[2] * (vut[3] * vut[7] - vut[4] * vut[6]);
    double sign = det < 0 ? -1.0 : 1.0;
    double rot[9] = {0};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) {
        rot[3 * r + c] = v[3 * r + 0] * u[3 * c + 0] +
                         v[3 * r + 1] * u[3 * c + 1] +
                         sign * v[3 * r + 2] * u[3 * c + 2];
      }
    double tr[3];
    for (int a = 0; a < 3; ++a)
      tr[a] = mq[a] - (rot[3 * a] * mp[0] + rot[3 * a + 1] * mp[1] +
                       rot[3 * a + 2] * mp[2]);
    // cur = cur @ rot^T + t;  final = delta @ final.
    for (int i = 0; i < ns; ++i) {
      float p[3] = {cur[3 * i], cur[3 * i + 1], cur[3 * i + 2]};
      for (int a = 0; a < 3; ++a)
        cur[3 * i + a] = static_cast<float>(rot[3 * a] * p[0] +
                                            rot[3 * a + 1] * p[1] +
                                            rot[3 * a + 2] * p[2] + tr[a]);
    }
    double nf[16];
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 4; ++c) {
        nf[4 * r + c] = rot[3 * r] * final_m[c] +
                        rot[3 * r + 1] * final_m[4 + c] +
                        rot[3 * r + 2] * final_m[8 + c];
      }
      nf[4 * r + 3] += tr[r];
    }
    for (int c = 0; c < 4; ++c) nf[12 + c] = final_m[12 + c];
    std::memcpy(final_m, nf, sizeof(final_m));
    ++it;
    if (it >= max_iterations) {
      converged = 1;
      break;
    }
    double cos_angle = 0.5 * (rot[0] + rot[4] + rot[8] - 1.0);
    double translation_sqr = tr[0] * tr[0] + tr[1] * tr[1] + tr[2] * tr[2];
    if (cos_angle >= rot_thresh && translation_sqr <= transformation_epsilon) {
      converged = 1;
      break;
    }
    double cur_mse = mse_sum / kept;
    if (std::fabs(cur_mse - prev_mse) < mse_abs) {
      converged = 1;
      break;
    }
    if (std::fabs(cur_mse - prev_mse) / prev_mse < euclidean_fitness_epsilon) {
      converged = 1;
      break;
    }
    prev_mse = cur_mse;
  }
  // getFitnessScore(): mean squared 1-NN distance over ALL source points of
  // the finally-transformed ORIGINAL source.
  double fit = 0.0;
  for (int i = 0; i < ns; ++i) {
    double p[3] = {src[3 * i], src[3 * i + 1], src[3 * i + 2]};
    float q[3];
    for (int a = 0; a < 3; ++a)
      q[a] = static_cast<float>(final_m[4 * a] * p[0] + final_m[4 * a + 1] * p[1] +
                                final_m[4 * a + 2] * p[2] + final_m[4 * a + 3]);
    float d2;
    t->nearest(q, &d2);
    fit += d2;
  }
  *fitness_out = fit / ns;
  std::memcpy(final_out, final_m, sizeof(final_m));
  *converged_out = converged;
  return it;
}

}  // extern "C"
