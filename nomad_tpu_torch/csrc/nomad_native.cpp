// Native host-runtime kernels (C ABI, loaded via ctypes).
//
// Reference analogs:
//  - structs.AllocsFit / ScoreFitBinPack / ScoreFitSpread
//    (nomad/structs/funcs.go:166-297) vectorized over the node axis
//  - the plan applier's per-node validation fan-out
//    (nomad/plan_apply_pool.go EvaluatePool + plan_apply.go:640
//    evaluateNodePlan) as one dense pass
//  - NetworkIndex port bitset accounting (nomad/structs/network.go)
//
// The device (CUDA) path owns scheduling-time scoring; these functions
// serve the HOST runtime: plan validation, columnar-mirror maintenance,
// and host-side fit checks, where a Python loop would otherwise sit in
// the commit path.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -ffp-contract=off
//        -o libnomad_native-<hash>.so nomad_native.cpp
//        (driven by nomad_tpu_torch/ops/_build.py at first use).  No
//        -march=native: with it GCC contracts `dst[d] += c * demand[d]`
//        in scatter_add_rank1 into a fused multiply-add, which rounds
//        once where numpy's np.add.at rounds twice; -ffp-contract=off
//        keeps every multiply and add rounding on its own.

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------
// allocs_fit_dense: for every node row, does `demand` fit in
// capacity-used?  out_fit[i] = 1 if fits.  dims = resource dimensions
// (cpu, mem, disk).
void allocs_fit_dense(const float* capacity, const float* used,
                      const float* demand, int n_rows, int dims,
                      uint8_t* out_fit) {
    for (int i = 0; i < n_rows; ++i) {
        const float* cap = capacity + (size_t)i * dims;
        const float* use = used + (size_t)i * dims;
        uint8_t ok = 1;
        for (int d = 0; d < dims; ++d) {
            if (use[d] + demand[d] > cap[d] + 1e-6f) { ok = 0; break; }
        }
        out_fit[i] = ok;
    }
}

// ---------------------------------------------------------------------
// score_fit_binpack / spread over all rows given a demand vector.
// binpack: 20 - 10^(free_cpu_frac) - 10^(free_mem_frac), normalized /18
// (structs/funcs.go:259-297).  spread negates the exponent terms' sense
// by scoring the *unused* fraction.
void score_fit_dense(const float* capacity, const float* used,
                     const float* demand, int n_rows, int dims,
                     int spread, float* out_score) {
    for (int i = 0; i < n_rows; ++i) {
        const float* cap = capacity + (size_t)i * dims;
        const float* use = used + (size_t)i * dims;
        float total = 0.0f;
        // dimension 0 = cpu, 1 = memory (disk excluded, matching the
        // reference which scores cpu+mem only)
        for (int d = 0; d < 2; ++d) {
            float c = cap[d];
            if (c <= 0.0f) { total = 40.0f; break; }
            float free_frac = (c - (use[d] + demand[d])) / c;
            if (free_frac < 0.0f) free_frac = 0.0f;
            if (free_frac > 1.0f) free_frac = 1.0f;
            total += spread ? powf(10.0f, 1.0f - free_frac)
                            : powf(10.0f, free_frac);
        }
        float score = (20.0f - total) / 18.0f;
        if (score < 0.0f) score = 0.0f;
        if (score > 1.0f) score = 1.0f;
        out_score[i] = score;
    }
}

// ---------------------------------------------------------------------
// Port bitsets: words-per-row layout matches ClusterMatrix.port_words.

static inline int port_in(const int32_t* ports, int n, int32_t p) {
    for (int i = 0; i < n; ++i) if (ports[i] == p) return 1;
    return 0;
}

// ports_check: for one row, are all `ports` free (or in freed set)?
int32_t ports_check(const uint32_t* port_words, int words_per_row,
                    int row, const int32_t* ports, int n_ports,
                    const int32_t* freed, int n_freed) {
    const uint32_t* w = port_words + (size_t)row * words_per_row;
    for (int i = 0; i < n_ports; ++i) {
        int32_t p = ports[i];
        if (p < 0 || (p >> 5) >= words_per_row) return 0;
        // duplicate within the request?
        for (int j = 0; j < i; ++j) if (ports[j] == p) return 0;
        if ((w[p >> 5] >> (p & 31)) & 1u) {
            if (!port_in(freed, n_freed, p)) return 0;
        }
    }
    return 1;
}

void ports_set(uint32_t* port_words, int words_per_row, int row,
               const int32_t* ports, int n_ports, int value) {
    uint32_t* w = port_words + (size_t)row * words_per_row;
    for (int i = 0; i < n_ports; ++i) {
        int32_t p = ports[i];
        if (p < 0 || (p >> 5) >= words_per_row) continue;
        if (value) w[p >> 5] |= (1u << (p & 31));
        else       w[p >> 5] &= ~(1u << (p & 31));
    }
}

// ---------------------------------------------------------------------
// scatter_add: used[rows[k]] += deltas[k] — the columnar mirror's alloc
// usage maintenance (incremental UpsertPlanResults bookkeeping).
void scatter_add(float* used, int dims, const int32_t* rows,
                 const float* deltas, int n) {
    for (int k = 0; k < n; ++k) {
        float* dst = used + (size_t)rows[k] * dims;
        const float* src = deltas + (size_t)k * dims;
        for (int d = 0; d < dims; ++d) dst[d] += src[d];
    }
}

// ---------------------------------------------------------------------
// validate_plan: the EvaluatePool equivalent — validate P placement
// groups (one per node) in a single call.
//
// Inputs per group g:
//   rows[g]            node row (-1 = unknown node -> reject)
//   demand[g*dims..]   summed placement demand on that node
//   freed[g*dims..]    resources freed by this plan's stops on that node
//   group port ranges  ports_off[g]..ports_off[g+1] into ports[]
//   freed port ranges  freed_off[g]..freed_off[g+1] into freed_ports[]
// Output: ok[g] = 1 if the node can take the placements.
void validate_plan(const float* capacity, const float* used,
                   const uint32_t* port_words, int words_per_row,
                   int dims,
                   const int32_t* rows, const float* demand,
                   const float* freed, const int32_t* ports,
                   const int32_t* ports_off, const int32_t* freed_ports,
                   const int32_t* freed_off, int n_groups,
                   uint8_t* ok) {
    for (int g = 0; g < n_groups; ++g) {
        int32_t row = rows[g];
        if (row < 0) { ok[g] = 0; continue; }
        const float* cap = capacity + (size_t)row * dims;
        const float* use = used + (size_t)row * dims;
        const float* dem = demand + (size_t)g * dims;
        const float* fre = freed + (size_t)g * dims;
        uint8_t fits = 1;
        for (int d = 0; d < dims; ++d) {
            if (use[d] + dem[d] - fre[d] > cap[d] + 1e-6f) {
                fits = 0; break;
            }
        }
        if (!fits) { ok[g] = 0; continue; }
        ok[g] = (uint8_t)ports_check(
            port_words, words_per_row, row,
            ports + ports_off[g], ports_off[g + 1] - ports_off[g],
            freed_ports + freed_off[g],
            freed_off[g + 1] - freed_off[g]);
    }
}

// ---------------------------------------------------------------------
// Bulk alloc materialization: the host-side commit path's per-alloc
// Python loop replaced by one call per dispatch.
//
// expand_pairs: flatten the resolved sparse bulk output — (row, count,
// score) triples from the device kernel — into per-alloc row/score
// arrays in placement order.  Returns the number of allocs written, or
// -1 if the total would exceed `cap` (caller sized the outputs wrong).
int32_t expand_pairs(const int32_t* rows, const int32_t* counts,
                     const float* scores, int n,
                     int32_t* out_rows, float* out_scores, int32_t cap) {
    int32_t w = 0;
    for (int k = 0; k < n; ++k) {
        int32_t c = counts[k];
        if (c <= 0) continue;
        if (w + c > cap) return -1;
        int32_t r = rows[k];
        float s = scores[k];
        for (int32_t j = 0; j < c; ++j) {
            out_rows[w] = r;
            out_scores[w] = s;
            ++w;
        }
    }
    return w;
}

// format_uuids: batch-format n 16-byte random blocks into the canonical
// 36-char 8-4-4-4-12 form (same layout as utils.generate_uuid, which
// hex-formats os.urandom(16)).  out must hold 36*n bytes.
void format_uuids(const uint8_t* rnd, int n, char* out) {
    static const char hexd[] = "0123456789abcdef";
    for (int i = 0; i < n; ++i) {
        const uint8_t* b = rnd + (size_t)i * 16;
        char* o = out + (size_t)i * 36;
        int pos = 0;
        for (int j = 0; j < 16; ++j) {
            uint8_t v = b[j];
            *o++ = hexd[v >> 4];
            *o++ = hexd[v & 15];
            pos += 2;
            if (pos == 8 || pos == 12 || pos == 16 || pos == 20)
                *o++ = '-';
        }
    }
}

// scatter_add_rank1: used[rows[k]] += counts[k] * demand — the resolve
// path's overlay/usage update for a bulk eval, without materializing the
// [K, dims] delta matrix on the Python side.
void scatter_add_rank1(float* used, int dims, const int32_t* rows,
                       const int32_t* counts, const float* demand,
                       int n) {
    for (int k = 0; k < n; ++k) {
        float c = (float)counts[k];
        if (c == 0.0f) continue;
        float* dst = used + (size_t)rows[k] * dims;
        for (int d = 0; d < dims; ++d) dst[d] += c * demand[d];
    }
}

int32_t nomad_native_abi_version(void) { return 2; }

}  // extern "C"
