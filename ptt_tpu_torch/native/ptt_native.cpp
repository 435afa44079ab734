// Native host-side functions of ptt_tpu_torch (a copy of the JAX package's
// native/ptt_native.cpp; the code is the same, so the two libraries built with
// the same flags give the same bits).
//
// (a) CPU oracles for the sampling and grouping kernels, with pointnet2's
// greedy schedule and tie-breaking: fps, fps_with_dist, ball_query. (b) Host
// preprocessing and scoring for the evaluators: the canonical-frame crop of
// the host evaluator, the box decode, and the batched reference 3D IoU and
// center distance the device evaluator scores with.
//
// Plain C linkage, driven through ctypes. All arrays are float32/int32,
// C-contiguous, caller-allocated.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Iterative farthest point sampling, identical schedule to pointnet2's CUDA
// kernel: idx[0] = 0; greedily add argmax of min-squared-distance; ties resolve
// to the lowest index (first strict maximum).
// xyz: (n, 3); out_idx: (m,)
void fps(const float* xyz, int n, int m, int32_t* out_idx) {
    if (n <= 0 || m <= 0) return;
    float* min_d2 = new float[n];
    for (int i = 0; i < n; ++i) min_d2[i] = 1e10f;
    int32_t farthest = 0;
    for (int s = 0; s < m; ++s) {
        out_idx[s] = farthest;
        const float* c = xyz + 3 * farthest;
        float best = -1.0f;
        int32_t best_i = 0;
        for (int i = 0; i < n; ++i) {
            const float dx = xyz[3 * i] - c[0];
            const float dy = xyz[3 * i + 1] - c[1];
            const float dz = xyz[3 * i + 2] - c[2];
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < min_d2[i]) min_d2[i] = d2;
            if (min_d2[i] > best) { best = min_d2[i]; best_i = i; }
        }
        farthest = best_i;
    }
    delete[] min_d2;
}

// FPS on a precomputed (n, n) squared-distance matrix ('ffps').
void fps_with_dist(const float* d2mat, int n, int m, int32_t* out_idx) {
    if (n <= 0 || m <= 0) return;
    float* min_d2 = new float[n];
    for (int i = 0; i < n; ++i) min_d2[i] = 1e10f;
    int32_t farthest = 0;
    for (int s = 0; s < m; ++s) {
        out_idx[s] = farthest;
        const float* row = d2mat + (int64_t)n * farthest;
        float best = -1.0f;
        int32_t best_i = 0;
        for (int i = 0; i < n; ++i) {
            if (row[i] < min_d2[i]) min_d2[i] = row[i];
            if (min_d2[i] > best) { best = min_d2[i]; best_i = i; }
        }
        farthest = best_i;
    }
    delete[] min_d2;
}

// Ball query with pointnet2's first-fit + duplicate-pad semantics: for each
// center, scan points in index order, keep the first `nsample` within `radius`,
// and pad the remainder with the FIRST hit (pointnet2_utils.py:265-294).
// xyz: (n, 3); centers: (m, 3); out_idx: (m, nsample)
void ball_query(const float* xyz, int n, const float* centers, int m,
                float radius, int nsample, int32_t* out_idx) {
    const float r2 = radius * radius;
    for (int j = 0; j < m; ++j) {
        const float cx = centers[3 * j], cy = centers[3 * j + 1], cz = centers[3 * j + 2];
        int32_t* row = out_idx + (int64_t)j * nsample;
        int cnt = 0;
        for (int i = 0; i < n && cnt < nsample; ++i) {
            const float dx = xyz[3 * i] - cx;
            const float dy = xyz[3 * i + 1] - cy;
            const float dz = xyz[3 * i + 2] - cz;
            if (dx * dx + dy * dy + dz * dz < r2) {
                if (cnt == 0)
                    for (int k = 0; k < nsample; ++k) row[k] = i;  // pre-pad with first hit
                row[cnt++] = i;
            }
        }
        if (cnt == 0)
            for (int k = 0; k < nsample; ++k) row[k] = 0;
    }
}

// Canonical-frame crop (host analog of geometry.crop_center_pc test path and the
// device crop_canonical): transform points into the box frame and mark those
// inside the scaled/offset box AABB.
// pts: (n, 3); box: [cx, cy, cz, yaw]; wlh: [w, l, h]
// out_pts: (n, 3) canonical coords; out_mask: (n,) 0/1. Returns kept count.
int crop_canonical(const float* pts, int n, const float* box, const float* wlh,
                   float offset, float scale, float* out_pts, int32_t* out_mask) {
    const float c = std::cos(box[3]), s = std::sin(box[3]);
    const float hx = wlh[1] * 0.5f * scale + offset;  // x extent = length/2
    const float hy = wlh[0] * 0.5f * scale + offset;  // y extent = width/2
    const float hz = wlh[2] * 0.5f * scale + offset;
    int kept = 0;
    for (int i = 0; i < n; ++i) {
        const float px = pts[3 * i] - box[0];
        const float py = pts[3 * i + 1] - box[1];
        const float pz = pts[3 * i + 2] - box[2];
        // row-vector p @ R, R = Rz(yaw)
        const float x = px * c + py * s;
        const float y = -px * s + py * c;
        out_pts[3 * i] = x;
        out_pts[3 * i + 1] = y;
        out_pts[3 * i + 2] = pz;
        const int32_t inside =
            (std::fabs(x) <= hx) && (std::fabs(y) <= hy) && (std::fabs(pz) <= hz);
        out_mask[i] = inside;
        kept += inside;
    }
    return kept;
}

// Gather masked rows compactly: out[k] = pts[i] for the k-th i with mask[i] != 0.
void compact_masked(const float* pts, const int32_t* mask, int n, float* out) {
    int k = 0;
    for (int i = 0; i < n; ++i) {
        if (mask[i]) {
            std::memcpy(out + 3 * k, pts + 3 * i, 3 * sizeof(float));
            ++k;
        }
    }
}

// Box decode (host analog of geometry.get_box_by_offset without the train-time
// resample guard): apply canonical-frame offset [dx, dy, dz, dtheta_deg].
void decode_box_offset(const float* box, const float* offset4, int use_z,
                       float* out_box) {
    const float c = std::cos(box[3]), s = std::sin(box[3]);
    const float dz = use_z ? offset4[2] : 0.0f;
    out_box[0] = box[0] + offset4[0] * c - offset4[1] * s;
    out_box[1] = box[1] + offset4[0] * s + offset4[1] * c;
    out_box[2] = box[2] + dz;
    out_box[3] = box[3] + offset4[3] * (float)(M_PI / 180.0);
}

}  // extern "C"

// ---------------------------------------------------------------- box IoU

namespace {

// Sutherland–Hodgman clip of convex polygon `subj` (n verts) by the half-plane
// left of edge a->b. Writes result to `out`, returns vertex count.
int clip_edge(const double* subj, int n, const double ax, const double ay,
              const double bx, const double by, double* out) {
    int m = 0;
    const double ex = bx - ax, ey = by - ay;
    for (int i = 0; i < n; ++i) {
        const double* P = subj + 2 * ((i + n - 1) % n);
        const double* C = subj + 2 * i;
        const double sp = ex * (P[1] - ay) - ey * (P[0] - ax);
        const double sc = ex * (C[1] - ay) - ey * (C[0] - ax);
        if (sc >= 0) {
            if (sp < 0) {
                const double t = sp / (sp - sc);
                out[2 * m] = P[0] + t * (C[0] - P[0]);
                out[2 * m + 1] = P[1] + t * (C[1] - P[1]);
                ++m;
            }
            out[2 * m] = C[0];
            out[2 * m + 1] = C[1];
            ++m;
        } else if (sp >= 0) {
            const double t = sp / (sp - sc);
            out[2 * m] = P[0] + t * (C[0] - P[0]);
            out[2 * m + 1] = P[1] + t * (C[1] - P[1]);
            ++m;
        }
    }
    return m;
}

double poly_area(const double* poly, int n) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) {
        const int j = (i + 1) % n;
        s += poly[2 * i] * poly[2 * j + 1] - poly[2 * j] * poly[2 * i + 1];
    }
    return std::fabs(s) * 0.5;
}

// box7 = [cx, cy, cz, w, l, h, yaw]; BEV footprint in x-y, CCW
void bev_corners(const float* b, double* out) {
    const double c = std::cos((double)b[6]), s = std::sin((double)b[6]);
    const double hl = b[4] * 0.5, hw = b[3] * 0.5;
    const double lx[4] = {hl, hl, -hl, -hl};
    const double ly[4] = {-hw, hw, hw, -hw};
    for (int i = 0; i < 4; ++i) {
        out[2 * i] = b[0] + lx[i] * c - ly[i] * s;
        out[2 * i + 1] = b[1] + lx[i] * s + ly[i] * c;
    }
}

}  // namespace

extern "C" {

// Batched 3D IoU + center distance for lidar-coordinate box pairs, reproducing
// the reference metric exactly (eval_tracking_metrics.py:52-74) including the
// camera-convention vertical-extent quirk (center[1]/height) by default;
// z_axis=1 computes the geometrically-correct z overlap (mid-height centers).
// Identical boxes short-circuit to IoU 1.0 like the reference's `box_a == box_b`.
// boxes: (n, 7) = [cx, cy, cz, w, l, h, yaw].
void box_iou3d_batch(const float* boxes_a, const float* boxes_b, int n,
                     int z_axis, float* out_iou, float* out_dist) {
    // A clip emits a vertex for each vertex inside and each crossing, so at
    // most 1.5x its input where rounding makes the polygon non-convex: 4
    // vertices grow to at most 19 over the four clips. Room for 32.
    double polyA[8], polyB[8], buf1[64], buf2[64];
    for (int i = 0; i < n; ++i) {
        const float* A = boxes_a + 7 * i;
        const float* B = boxes_b + 7 * i;
        const double dx = A[0] - B[0], dy = A[1] - B[1], dz = A[2] - B[2];
        out_dist[i] = (float)std::sqrt(dx * dx + dy * dy + dz * dz);
        if (std::memcmp(A, B, 7 * sizeof(float)) == 0) {
            out_iou[i] = 1.0f;
            continue;
        }
        bev_corners(A, polyA);
        bev_corners(B, polyB);
        // clip A by each edge of B
        int m = 4;
        std::memcpy(buf1, polyA, sizeof(polyA));
        double* cur = buf1;
        double* nxt = buf2;
        for (int e = 0; e < 4 && m > 0; ++e) {
            const int f = (e + 1) % 4;
            m = clip_edge(cur, m, polyB[2 * e], polyB[2 * e + 1],
                          polyB[2 * f], polyB[2 * f + 1], nxt);
            std::swap(cur, nxt);
        }
        const double inter_area = (m >= 3) ? poly_area(cur, m) : 0.0;
        double inter_h;
        if (z_axis) {
            const double zmax = std::min(A[2] + A[5] * 0.5, B[2] + B[5] * 0.5);
            const double zmin = std::max(A[2] - A[5] * 0.5, B[2] - B[5] * 0.5);
            inter_h = std::max(0.0, zmax - zmin);
        } else {  // reference quirk: vertical extent from center[1] and height
            const double ymax = std::min(A[1], B[1]);
            const double ymin = std::max(A[1] - A[5], B[1] - B[5]);
            inter_h = std::max(0.0, ymax - ymin);
        }
        const double inter_vol = inter_area * inter_h;
        const double volA = (double)A[3] * A[4] * A[5];
        const double volB = (double)B[3] * B[4] * B[5];
        const double denom = volA + volB - inter_vol;
        out_iou[i] = denom > 0 ? (float)(inter_vol / denom) : 0.0f;
    }
}

}  // extern "C"
