// Native map-graph runtime: the sequential, pointer-chasing maintenance
// loops of the SLAM map, operating zero-copy on the Python MapState's numpy
// buffers. This is the TPU-native analogue of the reference's C++ runtime
// layer (src/KeyFrame.cc covisibility/culling internals, src/LocalMapping.cc
// KeyFrameCulling :546-600, src/Optimizer.cc local-BA graph construction
// :287-380): the batched math lives in XLA kernels, while these inherently
// sequential graph walks live in native code instead of Python loops.
//
// Build: see Makefile (g++ -O3 -shared -fPIC). Loaded via ctypes with a
// pure-Python fallback, so the package works without the toolchain.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

// Covisibility weight (shared map point count) between keyframes a and b.
static int covis_weight(int a, int b, const int32_t* kf_point,
                        const int32_t* mp_obs_kf, int n_feat, int max_obs)
{
    int w = 0;
    const int32_t* pa = kf_point + (int64_t)a * n_feat;
    for (int f = 0; f < n_feat; ++f) {
        int p = pa[f];
        if (p < 0) continue;
        const int32_t* okf = mp_obs_kf + (int64_t)p * max_obs;
        for (int s = 0; s < max_obs; ++s)
            if (okf[s] == b) { ++w; break; }
    }
    return w;
}

// Spanning-tree child re-binding on keyframe deletion (KeyFrame.cc:497-588):
// candidates start as {parent}; each round binds the (child, candidate) pair
// with the globally largest covisibility weight (>= min_weight) and promotes
// the child to a candidate; leftovers inherit the grandparent.
static void reparent_children(int k, int32_t* kf_parent,
                              const uint8_t* kf_valid,
                              const int32_t* kf_point,
                              const int32_t* mp_obs_kf,
                              int max_kf, int n_feat, int max_obs,
                              int min_weight = 15)
{
    int parent = kf_parent[k];
    std::vector<int> children;
    for (int c = 0; c < max_kf; ++c)
        if (kf_parent[c] == k) children.push_back(c);
    std::vector<int> candidates;
    if (parent >= 0 && kf_valid[parent]) candidates.push_back(parent);
    while (!children.empty() && !candidates.empty()) {
        int best_w = min_weight - 1, best_ci = -1, best_p = -1;
        for (size_t ci = 0; ci < children.size(); ++ci)
            for (size_t pi = 0; pi < candidates.size(); ++pi) {
                int w = covis_weight(children[ci], candidates[pi],
                                     kf_point, mp_obs_kf, n_feat, max_obs);
                if (w > best_w) {
                    best_w = w;
                    best_ci = (int)ci;
                    best_p = candidates[pi];
                }
            }
        if (best_ci < 0) break;
        int c = children[best_ci];
        kf_parent[c] = best_p;
        candidates.push_back(c);
        children.erase(children.begin() + best_ci);
    }
    for (size_t ci = 0; ci < children.size(); ++ci)
        kf_parent[children[ci]] = parent;
    kf_parent[k] = -1;
}

extern "C" {

// ---------------------------------------------------------------------------
// Redundant-keyframe culling (LocalMapping::KeyFrameCulling semantics):
// erase candidates whose tracked points are >= `redundancy` covered by >= 3
// other keyframes at the same-or-finer pyramid level. Returns the number of
// culled keyframes; out_culled[] receives their indices.
//
// Arrays:
//  kf_point   (max_kf, n_feat) int32    feature -> point slot or -1
//  kf_level   (max_kf, n_feat) int32
//  mp_obs_kf  (max_mp, max_obs) int32   point -> observing KFs or -1
//  mp_obs_feat(max_mp, max_obs) int32
//  kf_valid   (max_kf,) uint8
// ---------------------------------------------------------------------------
int cull_redundant_keyframes(
    const int32_t* candidates, int n_candidates,
    int32_t* kf_point, const int32_t* kf_level, uint8_t* kf_valid,
    int32_t* mp_obs_kf, int32_t* mp_obs_feat, uint8_t* mp_valid,
    int32_t* mp_gen, int32_t* kf_parent,
    int max_kf, int n_feat, int max_mp, int max_obs,
    float redundancy, int32_t* out_culled)
{
    int n_culled = 0;
    for (int ci = 0; ci < n_candidates; ++ci) {
        int k = candidates[ci];
        if (k < 0 || k >= max_kf || !kf_valid[k]) continue;
        const int32_t* kp = kf_point + (int64_t)k * n_feat;
        const int32_t* kl = kf_level + (int64_t)k * n_feat;
        int n_points = 0, n_redundant = 0;
        for (int f = 0; f < n_feat; ++f) {
            int p = kp[f];
            if (p < 0) continue;
            ++n_points;
            int level = kl[f];
            int n_better = 0;
            const int32_t* okf = mp_obs_kf + (int64_t)p * max_obs;
            const int32_t* ofe = mp_obs_feat + (int64_t)p * max_obs;
            for (int s = 0; s < max_obs && n_better < 3; ++s) {
                int ok = okf[s];
                if (ok < 0 || ok == k) continue;
                int of = ofe[s];
                if (kf_level[(int64_t)ok * n_feat + of] <= level + 1) ++n_better;
            }
            if (n_better >= 3) ++n_redundant;
        }
        if (n_points == 0 || n_redundant <= redundancy * n_points) continue;

        // erase_keyframe: unlink observations; points dropping below 2 obs die
        for (int f = 0; f < n_feat; ++f) {
            int p = kp[f];
            if (p < 0) continue;
            int32_t* okf = mp_obs_kf + (int64_t)p * max_obs;
            int32_t* ofe = mp_obs_feat + (int64_t)p * max_obs;
            int n_obs = 0;
            for (int s = 0; s < max_obs; ++s) {
                if (okf[s] == k) { okf[s] = -1; ofe[s] = -1; }
                else if (okf[s] >= 0) ++n_obs;
            }
            if (n_obs < 2 && mp_valid[p]) {
                // erase_point
                for (int s = 0; s < max_obs; ++s) {
                    int ok2 = okf[s];
                    if (ok2 >= 0) {
                        int of2 = ofe[s];
                        int32_t* other = kf_point + (int64_t)ok2 * n_feat;
                        if (other[of2] == p) other[of2] = -1;
                    }
                    okf[s] = -1; ofe[s] = -1;
                }
                mp_valid[p] = 0;
                mp_gen[p] += 1;
            }
        }
        std::memset(kf_point + (int64_t)k * n_feat, 0xFF,
                    sizeof(int32_t) * n_feat);
        kf_valid[k] = 0;
        reparent_children(k, kf_parent, kf_valid, kf_point, mp_obs_kf,
                          max_kf, n_feat, max_obs);
        out_culled[n_culled++] = k;
    }
    return n_culled;
}

// ---------------------------------------------------------------------------
// Local-BA observation list construction (Optimizer::LocalBundleAdjustment
// graph assembly :287-380): for the given points, emit flat
// (kf_index, point_index, feat) triples for observations whose keyframe is
// in the kf_index_of[] mapping (>= 0). Returns count (capped at max_out).
// ---------------------------------------------------------------------------
int build_ba_obs(
    const int64_t* pts, int n_pts,
    const int32_t* mp_obs_kf, const int32_t* mp_obs_feat,
    const int32_t* kf_index_of,   // (max_kf,) dense kf slot -> problem index or -1
    int max_obs,
    int32_t* out_kf, int32_t* out_pt, int32_t* out_feat,
    int32_t* out_src_p, int32_t* out_src_k,
    int max_out)
{
    int n = 0;
    for (int i = 0; i < n_pts && n < max_out; ++i) {
        int64_t p = pts[i];
        const int32_t* okf = mp_obs_kf + p * max_obs;
        const int32_t* ofe = mp_obs_feat + p * max_obs;
        for (int s = 0; s < max_obs && n < max_out; ++s) {
            int k = okf[s];
            if (k < 0) continue;
            int ki = kf_index_of[k];
            if (ki < 0) continue;
            out_kf[n] = ki;
            out_pt[n] = i;
            out_feat[n] = ofe[s];
            out_src_p[n] = (int32_t)p;
            out_src_k[n] = k;
            ++n;
        }
    }
    return n;
}

// ---------------------------------------------------------------------------
// Batch observation insertion (MapPoint::AddObservation + KeyFrame::
// AddMapPoint for a whole keyframe at once). Skips full adjacency rows.
// Returns number inserted.
// ---------------------------------------------------------------------------
int add_observations(
    const int32_t* feats, const int32_t* points, int n,
    int kf,
    int32_t* kf_point, int32_t* mp_obs_kf, int32_t* mp_obs_feat,
    const uint8_t* mp_valid,
    int n_feat, int max_obs)
{
    int inserted = 0;
    for (int i = 0; i < n; ++i) {
        int f = feats[i];
        int p = points[i];
        if (p < 0 || !mp_valid[p]) continue;
        int32_t* okf = mp_obs_kf + (int64_t)p * max_obs;
        int32_t* ofe = mp_obs_feat + (int64_t)p * max_obs;
        bool present = false;
        int slot = -1;
        for (int s = 0; s < max_obs; ++s) {
            if (okf[s] == kf) { present = true; break; }
            if (okf[s] < 0 && slot < 0) slot = s;
        }
        if (present) continue;
        if (slot < 0) continue;  // adjacency row full
        okf[slot] = kf;
        ofe[slot] = f;
        kf_point[(int64_t)kf * n_feat + f] = p;
        ++inserted;
    }
    return inserted;
}

}  // extern "C"
