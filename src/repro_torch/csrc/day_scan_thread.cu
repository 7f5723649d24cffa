// The day scan's first Hopper design, kept as the baseline of
// `scripts/kernel_probe.py day`; no path of the port launches it.
//
// One thread per combo, 32 threads a block, the 9-float state in
// registers; every input of step t + 1 is loaded from global memory into
// registers while step t is computed, and each step's nine outputs are
// stored to global memory by the same thread.  csrc/day_scan.cu replaced
// it with a warp-specialised kernel that stages inputs and outputs in
// shared memory; the numerics (operations, order, -fmad=false, expf) are
// the same.
//
// `day_scan_probe_launch(..., mode)` runs it as is (0), with the first
// step's inputs held in registers and no per-step loads (1), or also with
// no stores, the outputs folded into one checksum written to soc_o's first
// row (2).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Row of each constant in the (C, N) matrix: sorted key order.
enum ConstRow {
  K_DSOC_COEFF, K_DT_C_SKIN, K_DT_C_SOC, K_G_SKIN_AMB, K_G_SOC_SKIN,
  K_HAS_PUCK, K_KNEE_SHARP, K_KNEE_V, K_MAX_LEVEL, K_P_DSOC_COEFF,
  K_P_DT_C_SKIN, K_P_DT_C_SOC, K_P_G_SKIN_AMB, K_P_G_SOC_SKIN,
  K_P_KNEE_SHARP, K_P_KNEE_V, K_P_R_OHM, K_P_SAG_V, K_P_STANDBY_MW,
  K_P_V_FULL, K_R_OHM, K_SAG_V, K_SHUTDOWN_C, K_SOC_CLEAR, K_SOC_TRIP,
  K_STANDBY_MW, K_STE_BETA_C, K_STE_BETA_SOC, K_TEMP_CLEAR, K_TEMP_TRIP,
  K_V_FULL, K_COUNT
};

struct Node {             // battery + thermal constants of one node
  float v_full, sag_v, knee_v, knee_sharp, r_ohm, dsoc_coeff;
  float g_soc_skin, g_skin_amb, dt_c_soc, dt_c_skin;
};

template <int LMAX>
struct StepIn {           // every input one step reads
  float mw[LMAX], mw_p[LMAX], pods[LMAX];
  float amb, active, valid, charge, charge_p;
};

struct Args {
  const float* mw;        // (T, L, N)
  const float* mw_p;      // (T, L, N)
  const float* pods;      // (T, L, N)
  const float* act_mult;  // (L, N)
  const float* ambient;   // (T, N)
  const float* active;    // (T, N)
  const float* valid;     // (T, N)
  const float* charge;    // (T, N)
  const float* charge_p;  // (T, N)
  const float* cst;       // (C, N)
  float* soc_o;           // (T, N) each
  float* soc_p_o;
  float* t_skin_o;
  float* t_skin_p_o;
  float* shut_o;
  int32_t* level_o;
  float* pods_o;
  float* drain_o;
  float* drain_p_o;
  int n, t_steps, n_lvl;
};

__device__ __forceinline__ Node load_node(const float* cst, int n, int i,
                                          bool puck) {
  auto c = [&](int k) { return cst[(int64_t)k * n + i]; };
  if (puck) {
    return {c(K_P_V_FULL), c(K_P_SAG_V), c(K_P_KNEE_V), c(K_P_KNEE_SHARP),
            c(K_P_R_OHM), c(K_P_DSOC_COEFF), c(K_P_G_SOC_SKIN),
            c(K_P_G_SKIN_AMB), c(K_P_DT_C_SOC), c(K_P_DT_C_SKIN)};
  }
  return {c(K_V_FULL), c(K_SAG_V), c(K_KNEE_V), c(K_KNEE_SHARP), c(K_R_OHM),
          c(K_DSOC_COEFF), c(K_G_SOC_SKIN), c(K_G_SKIN_AMB), c(K_DT_C_SOC),
          c(K_DT_C_SKIN)};
}

template <int LMAX>
__device__ __forceinline__ void load_step(const Args& a, int t, int i,
                                          StepIn<LMAX>& s) {
  const int64_t row = (int64_t)t * a.n + i;
  const int64_t tab = (int64_t)t * a.n_lvl * a.n + i;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    if (l < a.n_lvl) {
      s.mw[l] = a.mw[tab + (int64_t)l * a.n];
      s.mw_p[l] = a.mw_p[tab + (int64_t)l * a.n];
      s.pods[l] = a.pods[tab + (int64_t)l * a.n];
    } else {
      s.mw[l] = 0.0f;
      s.mw_p[l] = 0.0f;
      s.pods[l] = 0.0f;
    }
  }
  s.amb = a.ambient[row];
  s.active = a.active[row];
  s.valid = a.valid[row];
  s.charge = a.charge[row];
  s.charge_p = a.charge_p[row];
}

// Entry `lv` of a per-level register array (fully unrolled selects, so the
// array never spills to local memory).
template <int LMAX>
__device__ __forceinline__ float pick(const float (&v)[LMAX], int lv) {
  float out = v[0];
#pragma unroll
  for (int l = 1; l < LMAX; ++l) out = (l == lv) ? v[l] : out;
  return out;
}

// daysim._node_step, same operations in the same order.
__device__ __forceinline__ void node_step(const Node& k, float& soc,
                                          float& t_soc, float& t_skin,
                                          float p_mw, float charge_mw,
                                          float amb, float& drain_mw) {
  const float v = k.v_full - k.sag_v * (1.0f - soc)
                  - k.knee_v * expf(-k.knee_sharp * soc);
  const float i_a = p_mw * 1e-3f / v;
  const float loss_mw = i_a * i_a * k.r_ohm * 1e3f;
  drain_mw = p_mw + loss_mw;
  const float soc_n = fminf(fmaxf(soc - drain_mw * k.dsoc_coeff
                                  + charge_mw * k.dsoc_coeff, 0.0f), 1.0f);
  const float heat_w = drain_mw * 1e-3f;
  const float flow = (t_soc - t_skin) * k.g_soc_skin;
  const float t_soc_n = t_soc + (heat_w - flow) * k.dt_c_soc;
  const float t_skin_n = t_skin + (flow - (t_skin - amb) * k.g_skin_amb)
                                  * k.dt_c_skin;
  soc = soc_n;
  t_soc = t_soc_n;
  t_skin = t_skin_n;
}

// One combo's whole day (daysim._integrate_one over daysim._step_math).
template <int LMAX, int MODE>
__device__ __forceinline__ void day_thread(const Args& a, int i) {
  const int n = a.n;
  auto c = [&](int k) { return a.cst[(int64_t)k * n + i]; };
  const float temp_trip = c(K_TEMP_TRIP), temp_clear = c(K_TEMP_CLEAR);
  const float soc_trip = c(K_SOC_TRIP), soc_clear = c(K_SOC_CLEAR);
  const float max_level = c(K_MAX_LEVEL), shutdown_c = c(K_SHUTDOWN_C);
  const float has_puck = c(K_HAS_PUCK);
  const float standby_mw = c(K_STANDBY_MW), p_standby_mw = c(K_P_STANDBY_MW);
  const Node glasses = load_node(a.cst, n, i, false);
  const Node puck = load_node(a.cst, n, i, true);
  float amult[LMAX];
#pragma unroll
  for (int l = 0; l < LMAX; ++l)
    amult[l] = l < a.n_lvl ? a.act_mult[(int64_t)l * n + i] : 0.0f;

  const float amb0 = a.ambient[i];
  float soc = 1.0f, soc_p = 1.0f;
  float t_soc = amb0, t_skin = amb0, t_soc_p = amb0, t_skin_p = amb0;
  float th_state = 0.0f, soc_state = 0.0f, shut = 0.0f;

  uint32_t checksum = 0;
  StepIn<LMAX> cur, nxt;
  if (a.t_steps > 0) load_step(a, 0, i, cur);
  for (int t = 0; t < a.t_steps; ++t) {
    if (MODE == 0 && t + 1 < a.t_steps) load_step(a, t + 1, i, nxt);

    // hysteresis triggers on the previous step's state
    const float trip_t = t_skin > temp_trip ? 1.0f : 0.0f;
    const float clear_t = t_skin < temp_clear ? 1.0f : 0.0f;
    th_state = trip_t + (1.0f - trip_t) * (1.0f - clear_t) * th_state;
    const float soc_eff = fminf(soc, soc_p);
    const float trip_s = soc_eff < soc_trip ? 1.0f : 0.0f;
    const float clear_s = soc_eff > soc_clear ? 1.0f : 0.0f;
    soc_state = trip_s + (1.0f - trip_s) * (1.0f - clear_s) * soc_state;
    const float level_f = fminf(th_state + soc_state, max_level);
    const int lv = (int)level_f;   // an exact small integer

    // latched thermal shutdown, either node
    shut = fmaxf(shut, t_skin > shutdown_c ? 1.0f : 0.0f);
    shut = fmaxf(shut, (t_skin_p > shutdown_c ? 1.0f : 0.0f) * has_puck);

    const float alive = (soc > 0.0f ? 1.0f : 0.0f)
                        * (soc_p > 0.0f ? 1.0f : 0.0f)
                        * (1.0f - shut) * cur.valid;
    const float act = cur.active * pick(amult, lv);
    const float p_mw = (act * pick(cur.mw, lv)
                        + (1.0f - act) * standby_mw) * alive;
    const float p_p_mw = (act * pick(cur.mw_p, lv)
                          + (1.0f - act) * p_standby_mw) * alive * has_puck;

    float drain_mw, drain_p_mw;
    node_step(glasses, soc, t_soc, t_skin, p_mw, cur.charge, cur.amb,
              drain_mw);
    node_step(puck, soc_p, t_soc_p, t_skin_p, p_p_mw, cur.charge_p,
              cur.amb, drain_p_mw);
    const float pods = act * pick(cur.pods, lv) * alive;

    if (MODE == 2) {
      checksum ^= ((__float_as_uint(soc) ^ __float_as_uint(soc_p))
                   ^ (__float_as_uint(t_skin) ^ __float_as_uint(t_skin_p)))
                  ^ ((__float_as_uint(shut) ^ (uint32_t)lv)
                     ^ (__float_as_uint(pods) ^ __float_as_uint(drain_mw)))
                  ^ __float_as_uint(drain_p_mw);
    } else {
      const int64_t o = (int64_t)t * n + i;
      a.soc_o[o] = soc;
      a.soc_p_o[o] = soc_p;
      a.t_skin_o[o] = t_skin;
      a.t_skin_p_o[o] = t_skin_p;
      a.shut_o[o] = shut;
      a.level_o[o] = lv;
      a.pods_o[o] = pods;
      a.drain_o[o] = drain_mw;
      a.drain_p_o[o] = drain_p_mw;
    }
    if (MODE == 0) cur = nxt;
  }
  if (MODE == 2 && a.t_steps > 0) a.soc_o[i] = __uint_as_float(checksum);
}

template <int LMAX, int MODE>
__global__ void __launch_bounds__(32) day_scan_kernel(Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) day_thread<LMAX, MODE>(a, i);
}

template <int MODE>
int launch(const Args& a, cudaStream_t s) {
  const dim3 block(32);
  const dim3 grid((a.n + 31) / 32);
  if (a.n_lvl <= 4) {
    day_scan_kernel<4, MODE><<<grid, block, 0, s>>>(a);
  } else if (a.n_lvl <= 8) {
    day_scan_kernel<8, MODE><<<grid, block, 0, s>>>(a);
  } else {
    day_scan_kernel<16, MODE><<<grid, block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes), the signature of csrc/day_scan.cu's
// probe entry.  Launches on `stream`, does not synchronise, allocates
// nothing; returns cudaGetLastError() (0 = success).
extern "C" int day_scan_probe_launch(
    const float* mw, const float* mw_p, const float* pods,
    const float* act_mult, const float* ambient, const float* active,
    const float* valid, const float* charge, const float* charge_p,
    const float* cst, float* soc_o, float* soc_p_o, float* t_skin_o,
    float* t_skin_p_o, float* shut_o, int32_t* level_o, float* pods_o,
    float* drain_o, float* drain_p_o, int n, int t_steps, int n_lvl,
    int n_const, void* stream, int mode) {
  if (n_const != K_COUNT || n_lvl < 1 || n_lvl > 16 || n < 0 || t_steps < 0
      || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Args a{mw, mw_p, pods, act_mult, ambient, active, valid, charge, charge_p,
         cst, soc_o, soc_p_o, t_skin_o, t_skin_p_o, shut_o, level_o, pods_o,
         drain_o, drain_p_o, n, t_steps, n_lvl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) return launch<1>(a, s);
  if (mode == 2) return launch<2>(a, s);
  return launch<0>(a, s);
}
