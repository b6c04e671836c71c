// Host-side AER kernels of the port (its own copy of
// v2e_tpu/native/aer_kernels.cpp, with the same six functions and the same
// arithmetic).
//
// They do the host half of the event pipeline: expanding the compacted
// per-pixel count maps the device returns into AER event lists
// (materialize_sparse, materialize_frame, count_frame_events; the
// semantics are those of v2e_tpu_torch/emulator/events.py), packing
// AEDAT-2 words (pack_aedat2), and the DVS video's signed histogram and
// AREA_COUNT exposure scan (hist2d_accumulate, area_count_scan).
//
// Build: g++ -O3 -march=native -ffp-contract=off -shared -fPIC (see
// __init__.py).  -ffp-contract=off keeps `t0 + (it + 1) * s` two roundings,
// as numpy computes it, so every function equals its numpy version bit for
// bit.  Bound with ctypes; a host without g++ takes the numpy versions.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>

extern "C" {

// Accumulate a signed ON-OFF event histogram into `frame` (float32 [H,W]),
// clipping to +-full_scale after adding this packet's events.
void hist2d_accumulate(const double* events,  // [n,4] t,x,y,p rows
                       int64_t n, int64_t H, int64_t W,
                       float full_scale, float* frame) {
  for (int64_t i = 0; i < n; ++i) {
    const double* e = events + 4 * i;
    int64_t x = (int64_t)e[1];
    int64_t y = (int64_t)e[2];
    if (x < 0 || x >= W || y < 0 || y >= H) continue;
    float* cell = frame + y * W + x;
    *cell += (e[3] > 0) ? 1.0f : -1.0f;
  }
  int64_t total = H * W;
  for (int64_t i = 0; i < total; ++i) {
    frame[i] = std::min(std::max(frame[i], -full_scale), full_scale);
  }
}

// Sequentially scan events incrementing per-area counts until any area
// reaches `area_count`; returns the index of the event that completed the
// frame (or n if none did). Resets counts when the frame completes,
// as the original v2e's AREA_COUNT exposure mode does.
int64_t area_count_scan(const double* events, int64_t n, int64_t start,
                        int64_t area_dimension, int64_t area_count,
                        int64_t* counts, int64_t nw, int64_t nh) {
  int64_t i = start;
  for (; i < n; ++i) {
    const double* e = events + 4 * i;
    int64_t ax = (int64_t)(e[1] / (double)area_dimension);
    int64_t ay = (int64_t)(e[2] / (double)area_dimension);
    if (ax < 0 || ax >= nw || ay < 0 || ay >= nh) continue;
    int64_t c = ++counts[ax * nh + ay];
    if (c >= area_count) {
      std::memset(counts, 0, sizeof(int64_t) * nw * nh);
      return i;
    }
  }
  return i;
}

// Expand one frame's dense signed count map into AER events.
//
// Inputs: ev_count i16[H*W] signed final counts, i0 i16[H*W] first emitted
// iteration, iteration stride, timestamp grid (t_prev + (i+1)*ts_step),
// optional shot_on/shot_off uint8 maps (events at t_frame).
// Output arrays must be sized >= total event count; returns events written.
// Events are written iteration-major; within an iteration in raster order
// with ON/OFF interleaved by pixel position (the caller shuffles within
// iterations if desired - timestamps within an iteration are equal).
int64_t materialize_frame(const int16_t* ev_count, const int16_t* i0,
                          int64_t stride, int64_t H, int64_t W,
                          double t_prev, double ts_step, double t_frame,
                          const uint8_t* shot_on, const uint8_t* shot_off,
                          int64_t K,
                          double* out /* [cap,4] */, uint8_t* out_label,
                          int64_t cap) {
  int64_t written = 0;
  // bucket events by iteration using counting sort over K iterations
  // pass 1: count events per iteration
  if (K > 0) {
    int64_t* iter_counts = new int64_t[K + 1]();
    const int64_t npix = H * W;
    for (int64_t p = 0; p < npix; ++p) {
      int16_t c = ev_count[p];
      if (c == 0) continue;
      int64_t cc = c > 0 ? c : -c;
      int64_t first = i0[p];
      for (int64_t j = 0; j < cc; ++j) {
        int64_t it = first + j * stride;
        if (it >= 0 && it < K) iter_counts[it]++;
      }
    }
    // prefix sums -> write offsets
    int64_t acc = 0;
    for (int64_t it = 0; it < K; ++it) {
      int64_t c = iter_counts[it];
      iter_counts[it] = acc;
      acc += c;
    }
    if (acc > cap) { delete[] iter_counts; return -1; }
    // pass 2: scatter events into iteration buckets
    for (int64_t p = 0; p < npix; ++p) {
      int16_t c = ev_count[p];
      if (c == 0) continue;
      int64_t cc = c > 0 ? c : -c;
      double pol = c > 0 ? 1.0 : -1.0;
      double x = (double)(p % W);
      double y = (double)(p / W);
      int64_t first = i0[p];
      for (int64_t j = 0; j < cc; ++j) {
        int64_t it = first + j * stride;
        if (it < 0 || it >= K) continue;
        int64_t idx = iter_counts[it]++;
        double* e = out + 4 * idx;
        e[0] = t_prev + (double)(it + 1) * ts_step;
        e[1] = x;
        e[2] = y;
        e[3] = pol;
        if (out_label) out_label[idx] = 1;
      }
    }
    written = acc;
    delete[] iter_counts;
  }
  // shot noise events appended last at t_frame: ON raster order, then OFF
  if (shot_on) {
    const int64_t npix = H * W;
    for (int pass = 0; pass < 2; ++pass) {
      const uint8_t* mask = pass == 0 ? shot_on : shot_off;
      double pol = pass == 0 ? 1.0 : -1.0;
      for (int64_t p = 0; p < npix; ++p) {
        if (!mask[p]) continue;
        if (written >= cap) return -1;
        double* e = out + 4 * written;
        e[0] = t_frame;
        e[1] = (double)(p % W);
        e[2] = (double)(p / W);
        e[3] = pol;
        if (out_label) out_label[written] = 0;
        ++written;
      }
    }
  }
  return written;
}

// Total number of events a frame will materialize (for buffer sizing).
int64_t count_frame_events(const int16_t* ev_count, int64_t npix,
                           const uint8_t* shot_on, const uint8_t* shot_off) {
  int64_t total = 0;
  for (int64_t p = 0; p < npix; ++p) {
    int16_t c = ev_count[p];
    total += c > 0 ? c : -c;
  }
  if (shot_on) {
    for (int64_t p = 0; p < npix; ++p) total += (shot_on[p] ? 1 : 0) + (shot_off[p] ? 1 : 0);
  }
  return total;
}

// Pack AER events into AEDAT-2.0 address/timestamp int32 pairs (big-endian
// handled by the caller via byteswap; this fills native-endian values).
void pack_aedat2(const double* events, int64_t n,
                 int64_t sizex, int64_t sizey,
                 int64_t xshift, int64_t yshift, int64_t polshift,
                 int32_t flip, const uint8_t* noise_mask,
                 int32_t* out /* [2n] */) {
  for (int64_t i = 0; i < n; ++i) {
    const double* e = events + 4 * i;
    int32_t x = (int32_t)e[1];
    int32_t y = (int32_t)e[2];
    if (flip) {
      x = (int32_t)(sizex - 1) - x;
      y = (int32_t)(sizey - 1) - y;
    }
    int32_t p = e[3] > 0 ? 1 : 0;
    int32_t a = (x << xshift) | (y << yshift) | (p << polshift);
    if (noise_mask && !noise_mask[i]) a |= (1 << 10);
    out[2 * i] = a;
    out[2 * i + 1] = (int32_t)(e[0] * 1e6);
  }
}


// Expand device-compacted sparse entries into time-ordered AER events for a
// whole chunk (the native version of events.py::materialize_events_sparse;
// semantics documented there).
//
// Entries arrive sorted by flat cell index (frame-major).  Events of one
// frame are filled in the same order the numpy path concatenates them
// (signal in entry order, then shot-ON, then shot-OFF) and stably sorted by
// (iteration, kind[, rand_key]) — exactly np.lexsort's key order — so the
// output is bit-identical to the numpy path, including the shuffled case
// when the caller pre-draws rand_keys with the same generator.
struct SparseEv {
  int64_t it;
  int32_t pix;
  int8_t sub;   // 0 signal, 1 shot-on, 2 shot-off
  int8_t pol;   // +1 / -1
  double key;   // random tie-break (0 when not shuffling)
};

int64_t materialize_sparse(
    const int32_t* idx, const int16_t* count, const int16_t* i0,
    const uint8_t* shot,            // may be null
    int64_t n_entries,
    const int64_t* stride, const int64_t* K,             // [F]
    const double* t0, const double* tf, const double* s, // [F]
    int64_t F, int64_t H, int64_t W,
    const double* rand_keys,        // null or [total]
    double* events,                 // [total,4]
    uint8_t* labels,                // null or [total]
    int64_t* offsets) {             // [F+1]
  const int64_t HW = H * W;
  // pass 1: per-frame totals
  int64_t* per_frame = new int64_t[F]();
  int64_t total_sig = 0, total_son = 0;
  for (int64_t e = 0; e < n_entries; ++e) {
    int64_t fr = idx[e] / HW;
    if (fr < 0 || fr >= F) continue;
    int16_t c = count[e];
    int64_t cc = c > 0 ? c : -c;
    per_frame[fr] += cc;
    total_sig += cc;
    if (shot) {
      if (shot[e] & 1) { ++per_frame[fr]; ++total_son; }
      if (shot[e] & 2) { ++per_frame[fr]; }
    }
  }
  offsets[0] = 0;
  for (int64_t f = 0; f < F; ++f) offsets[f + 1] = offsets[f] + per_frame[f];
  const int64_t total = offsets[F];
  // pass 2: fill per-frame segments in numpy concatenation order
  SparseEv* buf = new SparseEv[total];
  int64_t* cur = per_frame;  // reuse as write cursors
  for (int64_t f = 0; f < F; ++f) cur[f] = offsets[f];
  int64_t g = 0;  // global rand-key index (signal block)
  for (int64_t e = 0; e < n_entries; ++e) {
    int64_t fr = idx[e] / HW;
    if (fr < 0 || fr >= F) continue;
    int16_t c = count[e];
    if (c == 0) continue;
    int64_t cc = c > 0 ? c : -c;
    int32_t pix = (int32_t)(idx[e] % HW);
    int8_t pol = c > 0 ? 1 : -1;
    int64_t first = i0[e];
    int64_t st = stride[fr];
    for (int64_t j = 0; j < cc; ++j) {
      SparseEv& ev = buf[cur[fr]++];
      ev.it = first + j * st;
      ev.pix = pix;
      ev.sub = 0;
      ev.pol = pol;
      ev.key = rand_keys ? rand_keys[g] : 0.0;
      ++g;
    }
  }
  if (shot) {
    int64_t g_on = total_sig, g_off = total_sig + total_son;
    for (int pass = 0; pass < 2; ++pass) {
      uint8_t bit = pass == 0 ? 1 : 2;
      int8_t sub = pass == 0 ? 1 : 2;
      int8_t pol = pass == 0 ? 1 : -1;
      int64_t* gp = pass == 0 ? &g_on : &g_off;
      for (int64_t e = 0; e < n_entries; ++e) {
        if (!(shot[e] & bit)) continue;
        int64_t fr = idx[e] / HW;
        if (fr < 0 || fr >= F) continue;
        SparseEv& ev = buf[cur[fr]++];
        ev.it = K[fr] > 1 ? K[fr] : 1;  // one past the signal grid
        ev.pix = (int32_t)(idx[e] % HW);
        ev.sub = sub;
        ev.pol = pol;
        ev.key = rand_keys ? rand_keys[*gp] : 0.0;
        ++(*gp);
      }
    }
  }
  // pass 3: per-frame stable sort by (it, sub[, key]) and emit
  for (int64_t f = 0; f < F; ++f) {
    SparseEv* a = buf + offsets[f];
    SparseEv* b = buf + offsets[f + 1];
    if (rand_keys) {
      std::stable_sort(a, b, [](const SparseEv& l, const SparseEv& r) {
        if (l.it != r.it) return l.it < r.it;
        if (l.sub != r.sub) return l.sub < r.sub;
        return l.key < r.key;
      });
    } else {
      std::stable_sort(a, b, [](const SparseEv& l, const SparseEv& r) {
        if (l.it != r.it) return l.it < r.it;
        return l.sub < r.sub;
      });
    }
    double t0f = t0[f], sf = s[f], tff = tf[f];
    for (int64_t i = offsets[f]; i < offsets[f + 1]; ++i) {
      const SparseEv& ev = buf[i];
      double* o = events + 4 * i;
      o[0] = ev.sub == 0 ? t0f + (double)(ev.it + 1) * sf : tff;
      o[1] = (double)(ev.pix % W);
      o[2] = (double)(ev.pix / W);
      o[3] = (double)ev.pol;
      if (labels) labels[i] = ev.sub == 0 ? 1 : 0;
    }
  }
  delete[] buf;
  delete[] per_frame;
  return total;
}

}  // extern "C"
