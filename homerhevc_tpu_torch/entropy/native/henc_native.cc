// Native CABAC slice-data encoder: production twin of the Python oracle in
// entropy/syntax.py + entropy/cabac.py (bit-for-bit identical output,
// enforced by tests/test_torch_host.py).
//
// Role of the reference's hmr_arithmetic_encoding.c + hmr_binary_encoding.c
// (homer_lib), re-written from ITU-T H.265: the
// sequential CABAC pass is the one encoder stage that cannot batch onto the
// device, so it runs as native host code over the dense unit-granular plan
// arrays produced by the device pipelines.
//
// Build (entropy/native_backend.py, at first use): g++ -O3 -shared -fPIC
// -I <build dir> henc_native.cc -o libhenc-<hash>.so; layout.h is generated
// from the Python tables by gen_layout.py into that build directory.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <vector>

#include "layout.h"

namespace {

// Optional RD-diagnostics probe: exact fractional bits (-log2 p) per syntax
// category, accumulated while encoding (role of the reference's counter
// twin's fracBits bookkeeping, hmr_binary_encoding.c:280-301, repurposed as
// a measurement tool). Enabled via henc_set_bit_probe; zero cost when off.
enum BitCat {
  CAT_SAO = 0, CAT_SPLIT_CU, CAT_SKIP, CAT_MERGE, CAT_PRED_PART, CAT_MVD,
  CAT_MVP, CAT_INTRA_MODE, CAT_TT, CAT_LAST_XY, CAT_SIG, CAT_LEVEL,
  CAT_DQP, CAT_TERM, N_BIT_CAT
};
static double* g_cat_bits = nullptr;

// ------------------------------------------------------------------ bits
struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nbits = 0;
  void put(uint32_t val, int n) {
    acc = (acc << n) | (val & ((1ull << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      buf.push_back((uint8_t)(acc >> nbits));
    }
  }
  void align_zero() {
    if (nbits) put(0, 8 - nbits);
  }
};

// ------------------------------------------------------------------ BAC
struct Bac {
  BitWriter* bw;
  uint32_t low = 0, range = 510;
  int outstanding = 0;
  bool first = true;
  uint8_t* state;  // NUM_CTX
  uint8_t* mps;
  int cat = CAT_TERM;  // current syntax category for the bit probe

  void put_bit(int b) {
    if (first)
      first = false;
    else
      bw->put(b, 1);
    while (outstanding > 0) {
      bw->put(1 - b, 1);
      outstanding--;
    }
  }
  void renorm() {
    while (range < 256) {
      if (low >= 512) {
        low -= 512;
        put_bit(1);
      } else if (low < 256) {
        put_bit(0);
      } else {
        low -= 256;
        outstanding++;
      }
      range <<= 1;
      low <<= 1;
    }
  }
  void bin(int ctx, int v) {
    int st = state[ctx], m = mps[ctx];
    uint32_t lps = RANGE_TAB_LPS[st][(range >> 6) & 3];
    if (g_cat_bits)
      g_cat_bits[cat] += std::log2(
          (double)range / (double)(v != m ? lps : range - lps));
    range -= lps;
    if (v != m) {
      low += range;
      range = lps;
      if (st == 0) mps[ctx] = 1 - m;
      state[ctx] = TRANS_IDX_LPS[st];
    } else {
      state[ctx] = TRANS_IDX_MPS[st];
    }
    renorm();
  }
  void bypass(int v) {
    if (g_cat_bits) g_cat_bits[cat] += 1.0;
    low <<= 1;
    if (v) low += range;
    if (low >= 1024) {
      put_bit(1);
      low -= 1024;
    } else if (low < 512) {
      put_bit(0);
    } else {
      low -= 512;
      outstanding++;
    }
  }
  void bypass_bins(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) bypass((v >> i) & 1);
  }
  void terminate(int v) {
    if (g_cat_bits)
      g_cat_bits[CAT_TERM] +=
          std::log2((double)range / (double)(v ? 2 : range - 2));
    range -= 2;
    if (v) {
      low += range;
      range = 2;
      renorm();
      put_bit((low >> 9) & 1);
      bw->put(((low >> 7) & 3) | 1, 2);
    } else {
      renorm();
    }
  }
};

// ------------------------------------------------------------ scan tables
// Spec 6.5.3/6.5.4/6.5.5; identical to tables.scan_order / coeff_scan.
struct Scans {
  // coeff_scan[log2-2][mode]: flat raster indices in scan order
  std::vector<int32_t> coeff[4][3];
  // sub-block (x, y) scan for sizes 1, 2, 4, 8
  std::vector<int32_t> sub[4][3];  // pairs (x, y)

  static void scan_order(int n, int mode, std::vector<int32_t>& out) {
    out.clear();
    if (mode == 0) {  // diag
      int i = 0, x = 0, y = 0;
      while (i < n * n) {
        while (y >= 0) {
          if (x < n && y < n) {
            out.push_back(x);
            out.push_back(y);
            i++;
          }
          y--;
          x++;
        }
        y = x;
        x = 0;
      }
    } else if (mode == 1) {  // hor
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          out.push_back(x);
          out.push_back(y);
        }
    } else {  // ver
      for (int x = 0; x < n; x++)
        for (int y = 0; y < n; y++) {
          out.push_back(x);
          out.push_back(y);
        }
    }
  }

  Scans() {
    for (int lg = 2; lg <= 5; lg++) {
      int size = 1 << lg;
      for (int m = 0; m < 3; m++) {
        std::vector<int32_t>& out = coeff[lg - 2][m];
        if (size == 4) {
          std::vector<int32_t> s;
          scan_order(4, m, s);
          for (int k = 0; k < 16; k++) out.push_back(s[2 * k + 1] * 4 + s[2 * k]);
        } else {
          std::vector<int32_t> sb, in;
          scan_order(size / 4, m, sb);
          scan_order(4, m, in);
          for (size_t s = 0; s < sb.size() / 2; s++)
            for (int k = 0; k < 16; k++) {
              int x = sb[2 * s] * 4 + in[2 * k];
              int y = sb[2 * s + 1] * 4 + in[2 * k + 1];
              out.push_back(y * size + x);
            }
        }
        int nsb = size / 4 > 0 ? size / 4 : 1;
        scan_order(nsb, m, sub[lg - 2][m]);
      }
    }
  }
};
const Scans g_scans;

const int32_t GROUP_IDX[32] = {0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                               8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9};
const int32_t MIN_IN_GROUP[10] = {0, 1, 2, 3, 4, 6, 8, 12, 16, 24};
const int32_t SIG_CTX_4X4[16] = {0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8};

const int INTRA_PLANAR = 0, INTRA_DC = 1, INTRA_HOR = 10, INTRA_VER = 26;
const int SLICE_I = 2;

// -------------------------------------------------------------- params/maps
struct SliceParams {
  int32_t pic_width, pic_height;
  int32_t ctu_log2, min_cu_log2;
  int32_t max_tr_depth_intra, max_tr_depth_inter;
  int32_t sign_hiding, slice_type, max_merge_cand;
  int32_t wpp;  // entropy_coding_sync: per-CTU-row substreams + ctx sync
  int32_t sao_luma, sao_chroma;
  int32_t cu_qp_delta_enabled, slice_qp;
};

// Packed per-CTU SAO record (21 int8s; see native_backend.pack_sao):
// [0] merge_left [1] merge_up
// [2] type_l [3] eo_class_l [4] band_pos_l [5..8] off_l
// [9] type_c [10] eo_class_c [11] band_pos_cb [12..15] off_cb
// [16] band_pos_cr [17..20] off_cr
constexpr int SAO_REC = 21;

struct Maps {
  const int8_t *depth, *luma_mode, *chroma_mode, *tr_depth, *merge_idx,
      *mvp_idx;
  const int8_t* qp_ctu;  // (ny, nx) per-CTU coded QP, or nullptr
  const uint8_t *part_nxn, *pred_intra, *skip, *merge_flag;
  const int32_t* mvd;  // (uh, uw, 2), list 0
  const int32_t *cy, *ccb, *ccr;
  const int8_t* sao;   // (ny, nx, SAO_REC) or nullptr
  // B slices: prediction direction + list-1 motion
  const int8_t* inter_dir;   // 0=L0, 1=L1, 2=BI
  const int32_t* mvd1;       // (uh, uw, 2), list 1
  const int8_t* mvp_idx1;
};

int scan_mode_for_intra(int log2_size, int pred_mode, int c_idx) {
  if (log2_size == 2 || (log2_size == 3 && c_idx == 0)) {
    if (pred_mode >= 6 && pred_mode <= 14) return 2;
    if (pred_mode >= 22 && pred_mode <= 30) return 1;
  }
  return 0;
}

// -------------------------------------------------------------- the walker
struct SliceEnc {
  SliceParams p;
  Maps m;
  Bac* bac;
  int uw, uh, W, W2;
  // cu_qp_delta state (spec 8.6.1; QG == CTB so pred == qPY_PREV)
  int qp_prev = 26, qg_pred = 26, qg_target = 26;
  bool qg_coded = true;
  // walk-state grids
  std::vector<int8_t> g_depth, g_mode;
  std::vector<uint8_t> g_avail, g_intra, g_skip;

  SliceEnc(const SliceParams& p_, const Maps& m_, Bac* b) : p(p_), m(m_), bac(b) {
    uw = (p.pic_width + 3) / 4;
    uh = (p.pic_height + 3) / 4;
    W = p.pic_width;
    W2 = p.pic_width / 2;
    g_depth.assign(uw * uh, 0);
    g_mode.assign(uw * uh, INTRA_DC);
    g_avail.assign(uw * uh, 0);
    g_intra.assign(uw * uh, 0);
    g_skip.assign(uw * uh, 0);
  }

  inline int U(int x, int y) const { return (y / 4) * uw + (x / 4); }

  int sao_nx = 0;

  void sao_syntax(int rx, int ry) {
    bac->cat = CAT_SAO;
    const int8_t* e = m.sao + (ry * sao_nx + rx) * SAO_REC;
    bool ml = e[0], mu = e[1];
    if (rx > 0) bac->bin(OFF_SAO_MERGE, ml);
    if (!ml && ry > 0) bac->bin(OFF_SAO_MERGE, mu);
    if (ml || mu) return;
    for (int c = 0; c < 3; c++) {
      if (c == 0 && !p.sao_luma) continue;
      if (c > 0 && !p.sao_chroma) continue;
      int typ = c == 0 ? e[2] : e[9];
      int eo_cls = c == 0 ? e[3] : e[10];
      int band = c == 0 ? e[4] : (c == 1 ? e[11] : e[16]);
      const int8_t* off = c == 0 ? e + 5 : (c == 1 ? e + 12 : e + 17);
      if (c != 2) {
        bac->bin(OFF_SAO_TYPE, typ != 0);
        if (typ) bac->bypass(typ - 1);
      }
      if (typ == 0) continue;
      for (int i = 0; i < 4; i++) {
        int a = off[i] < 0 ? -off[i] : off[i];
        for (int k = 0; k < a; k++) bac->bypass(1);
        if (a < 7) bac->bypass(0);
      }
      if (typ == 1) {
        for (int i = 0; i < 4; i++)
          if (off[i]) bac->bypass(off[i] < 0);
        bac->bypass_bins(band, 5);
      } else if (c != 2) {
        bac->bypass_bins(eo_cls, 2);
      }
    }
  }

  void encode_ctu(int x0, int y0, bool is_last) {
    if (p.cu_qp_delta_enabled) {
      if (p.wpp && x0 == 0) qp_prev = p.slice_qp;
      qg_pred = qp_prev;
      qg_coded = false;
      int nx = (p.pic_width + (1 << p.ctu_log2) - 1) >> p.ctu_log2;
      qg_target = m.qp_ctu
                      ? m.qp_ctu[(y0 >> p.ctu_log2) * nx + (x0 >> p.ctu_log2)]
                      : p.slice_qp;
    }
    if (m.sao && (p.sao_luma || p.sao_chroma))
      sao_syntax(x0 >> p.ctu_log2, y0 >> p.ctu_log2);
    coding_quadtree(x0, y0, p.ctu_log2, 0);
    int size = 1 << p.ctu_log2;
    for (int y = y0; y < y0 + size && y < p.pic_height; y += 4)
      for (int x = x0; x < x0 + size && x < p.pic_width; x += 4)
        g_avail[U(x, y)] = 1;
    if (p.cu_qp_delta_enabled) qp_prev = qg_coded ? qg_target : qg_pred;
    bac->terminate(is_last ? 1 : 0);  // end_of_slice_segment_flag
  }

  // cu_qp_delta_abs (9.3.3.10: TR prefix cMax 5 + EG0 bypass) + sign
  void cu_qp_delta_bins(int delta) {
    bac->cat = CAT_DQP;
    int a = delta < 0 ? -delta : delta;
    int pre = a < 5 ? a : 5;
    bac->bin(OFF_DQP, pre > 0);
    for (int i = 1; i < pre; i++) bac->bin(OFF_DQP + 1, 1);
    if (pre < 5) {
      if (pre > 0) bac->bin(OFF_DQP + 1, 0);
    } else {
      int v = a - 5, k = 0;
      while (v >= (1 << (k + 1)) - 1) k++;
      for (int i = 0; i < k; i++) bac->bypass(1);
      bac->bypass(0);
      if (k) bac->bypass_bins(v - ((1 << k) - 1), k);
    }
    if (a) bac->bypass(delta < 0);
  }

  void coding_quadtree(int x0, int y0, int log2_size, int depth) {
    int size = 1 << log2_size;
    int cu_depth = m.depth[U(x0, y0)];
    bool inside = x0 + size <= p.pic_width && y0 + size <= p.pic_height;
    bool split = cu_depth > depth;
    if (inside && log2_size > p.min_cu_log2) {
      int gx = x0 / 4, gy = y0 / 4;
      int ctx = 0;
      if (gx > 0 && g_avail[gy * uw + gx - 1])
        ctx += g_depth[gy * uw + gx - 1] > depth;
      if (gy > 0 && g_avail[(gy - 1) * uw + gx])
        ctx += g_depth[(gy - 1) * uw + gx] > depth;
      bac->cat = CAT_SPLIT_CU;
      bac->bin(OFF_SPLIT_CU + ctx, split);
    } else if (!inside) {
      split = log2_size > p.min_cu_log2;
    }
    if (split) {
      int half = size >> 1;
      const int off[4][2] = {{0, 0}, {half, 0}, {0, half}, {half, half}};
      for (int i = 0; i < 4; i++) {
        int x1 = x0 + off[i][0], y1 = y0 + off[i][1];
        if (x1 < p.pic_width && y1 < p.pic_height)
          coding_quadtree(x1, y1, log2_size - 1, depth + 1);
      }
      return;
    }
    coding_unit(x0, y0, log2_size, depth);
  }

  void mark_cu(int x0, int y0, int log2_size, int depth, bool is_intra,
               bool skip) {
    int un = (1 << log2_size) / 4;
    int gx0 = x0 / 4, gy0 = y0 / 4;
    for (int y = gy0; y < gy0 + un; y++)
      for (int x = gx0; x < gx0 + un; x++) {
        g_depth[y * uw + x] = depth;
        g_intra[y * uw + x] = is_intra;
        g_skip[y * uw + x] = skip;
        g_avail[y * uw + x] = 1;
      }
  }

  void coding_unit(int x0, int y0, int log2_size, int depth) {
    if (p.slice_type != SLICE_I) {
      inter_coding_unit(x0, y0, log2_size, depth);
      return;
    }
    intra_coding_unit(x0, y0, log2_size, depth);
  }

  // ---------------------------------------------------------------- inter
  void merge_idx_bins(int idx) {
    bac->cat = CAT_MERGE;
    int cmax = p.max_merge_cand - 1;
    if (cmax == 0) return;
    bac->bin(OFF_MERGE_IDX, idx > 0);
    if (idx > 0) {
      for (int k = 1; k < idx; k++) bac->bypass(1);
      if (idx < cmax) bac->bypass(0);
    }
  }

  void egk(uint32_t value, int k) {
    while (value >= (1u << k)) {
      bac->bypass(1);
      value -= 1u << k;
      k++;
    }
    bac->bypass(0);
    if (k) bac->bypass_bins(value, k);
  }

  void mvd_coding(int mvd_x, int mvd_y) {
    bac->cat = CAT_MVD;
    int ax = mvd_x < 0 ? -mvd_x : mvd_x;
    int ay = mvd_y < 0 ? -mvd_y : mvd_y;
    bac->bin(OFF_MVD, ax > 0);
    bac->bin(OFF_MVD, ay > 0);
    if (ax > 0) bac->bin(OFF_MVD + 1, ax > 1);
    if (ay > 0) bac->bin(OFF_MVD + 1, ay > 1);
    if (ax > 0) {
      if (ax > 1) egk(ax - 2, 1);
      bac->bypass(mvd_x < 0);
    }
    if (ay > 0) {
      if (ay > 1) egk(ay - 2, 1);
      bac->bypass(mvd_y < 0);
    }
  }

  bool any_coeff(const int32_t* arr, int stride, int x, int y, int size) const {
    for (int r = 0; r < size; r++) {
      const int32_t* row = arr + (y + r) * stride + x;
      for (int c = 0; c < size; c++)
        if (row[c]) return true;
    }
    return false;
  }

  void inter_coding_unit(int x0, int y0, int log2_size, int depth) {
    int u = U(x0, y0);
    int gx = x0 / 4, gy = y0 / 4;
    bool skip = m.skip[u];
    int ctx = 0;
    if (gx > 0 && g_avail[gy * uw + gx - 1]) ctx += g_skip[gy * uw + gx - 1];
    if (gy > 0 && g_avail[(gy - 1) * uw + gx]) ctx += g_skip[(gy - 1) * uw + gx];
    bac->cat = CAT_SKIP;
    bac->bin(OFF_SKIP + ctx, skip);
    if (skip) {
      merge_idx_bins(m.merge_idx[u]);
      mark_cu(x0, y0, log2_size, depth, false, true);
      return;
    }
    bool is_intra = m.pred_intra && m.pred_intra[u];
    bac->cat = CAT_PRED_PART;
    bac->bin(OFF_PRED_MODE, is_intra);
    if (is_intra) {
      intra_coding_unit(x0, y0, log2_size, depth);
      return;
    }
    bac->bin(OFF_PART_SIZE, 1);  // PART_2Nx2N
    bool merge = m.merge_flag[u];
    bac->cat = CAT_MERGE;
    bac->bin(OFF_MERGE_FLAG, merge);
    if (merge) {
      merge_idx_bins(m.merge_idx[u]);
    } else {
      int idc = 0;
      if (p.slice_type == 0) {  // B slice: inter_pred_idc (9.3.3.8)
        idc = m.inter_dir ? m.inter_dir[u] : 0;
        bac->cat = CAT_MVP;
        bac->bin(OFF_INTER_DIR + depth, idc == 2);
        if (idc != 2) bac->bin(OFF_INTER_DIR + 4, idc == 1);
      }
      if (idc != 1) {
        mvd_coding(m.mvd[2 * u], m.mvd[2 * u + 1]);
        bac->cat = CAT_MVP;
        bac->bin(OFF_MVP_IDX, m.mvp_idx[u]);
      }
      if (idc != 0) {
        mvd_coding(m.mvd1[2 * u], m.mvd1[2 * u + 1]);
        bac->cat = CAT_MVP;
        bac->bin(OFF_MVP_IDX, m.mvp_idx1[u]);
      }
    }
    mark_cu(x0, y0, log2_size, depth, false, false);

    int size = 1 << log2_size;
    bool has_resid = any_coeff(m.cy, W, x0, y0, size) ||
                     any_coeff(m.ccb, W2, x0 / 2, y0 / 2, size / 2) ||
                     any_coeff(m.ccr, W2, x0 / 2, y0 / 2, size / 2);
    bac->cat = CAT_TT;
    if (!merge) bac->bin(OFF_ROOT_CBF, has_resid);
    if (has_resid)
      transform_tree(x0, y0, x0, y0, log2_size, 0, 0, false,
                     p.max_tr_depth_inter, true, true, false);
  }

  // ---------------------------------------------------------------- intra
  int neighbor_mode(int gx, int gy, bool is_above, int yctb) const {
    if (gx < 0 || gy < 0) return INTRA_DC;
    if (!g_avail[gy * uw + gx] || !g_intra[gy * uw + gx]) return INTRA_DC;
    if (is_above && gy * 4 < yctb) return INTRA_DC;
    return g_mode[gy * uw + gx];
  }

  void mpm_list(int x, int y, int out[3]) const {
    int gx = x / 4, gy = y / 4;
    int yctb = (y >> p.ctu_log2) << p.ctu_log2;
    int a = neighbor_mode(gx - 1, gy, false, yctb);
    int b = neighbor_mode(gx, gy - 1, true, yctb);
    if (a == b) {
      if (a < 2) {
        out[0] = INTRA_PLANAR;
        out[1] = INTRA_DC;
        out[2] = INTRA_VER;
      } else {
        out[0] = a;
        out[1] = 2 + ((a + 29) % 32);
        out[2] = 2 + ((a - 2 + 1) % 32);
      }
      return;
    }
    out[0] = a;
    out[1] = b;
    if (a != INTRA_PLANAR && b != INTRA_PLANAR)
      out[2] = INTRA_PLANAR;
    else if (a != INTRA_DC && b != INTRA_DC)
      out[2] = INTRA_DC;
    else
      out[2] = INTRA_VER;
  }

  void intra_coding_unit(int x0, int y0, int log2_size, int depth) {
    int u = U(x0, y0);
    int un = (1 << log2_size) / 4;
    bool part_nxn = m.part_nxn[u];

    if (log2_size == p.min_cu_log2) bac->bin(OFF_PART_SIZE, part_nxn ? 0 : 1);

    int nparts = part_nxn ? 4 : 1;
    int half = (1 << log2_size) >> 1;
    int offs[4][2] = {{0, 0}, {half, 0}, {0, half}, {half, half}};
    int modes[4], mpms[4][3];
    int pu_un = part_nxn ? un / 2 : un;
    for (int i = 0; i < nparts; i++) {
      int px = x0 + offs[i][0], py = y0 + offs[i][1];
      modes[i] = m.luma_mode[U(px, py)];
      mpm_list(px, py, mpms[i]);
      int gx0 = px / 4, gy0 = py / 4;
      for (int yy = gy0; yy < gy0 + pu_un; yy++)
        for (int xx = gx0; xx < gx0 + pu_un; xx++) {
          g_mode[yy * uw + xx] = modes[i];
          g_intra[yy * uw + xx] = 1;
          g_avail[yy * uw + xx] = 1;
        }
    }
    bac->cat = CAT_INTRA_MODE;
    for (int i = 0; i < nparts; i++) {
      bool in_mpm = modes[i] == mpms[i][0] || modes[i] == mpms[i][1] ||
                    modes[i] == mpms[i][2];
      bac->bin(OFF_INTRA_LUMA, in_mpm);
    }
    for (int i = 0; i < nparts; i++) {
      int mode = modes[i];
      int idx = -1;
      for (int k = 0; k < 3; k++)
        if (mode == mpms[i][k]) {
          idx = k;
          break;
        }
      if (idx >= 0) {
        bac->bypass(idx > 1 ? 1 : idx);
        if (idx) bac->bypass(idx - 1);
      } else {
        int rem = mode;
        for (int k = 0; k < 3; k++)
          if (mpms[i][k] < mode) rem--;
        bac->bypass_bins(rem, 5);
      }
    }

    int chroma_mode = m.chroma_mode[u];
    int luma0 = modes[0];
    int cand[4] = {INTRA_PLANAR, INTRA_VER, INTRA_HOR, INTRA_DC};
    for (int k = 0; k < 4; k++)
      if (cand[k] == luma0) {
        cand[k] = 34;
        break;
      }
    if (chroma_mode == luma0) {
      bac->bin(OFF_INTRA_CHROMA, 0);
    } else {
      bac->bin(OFF_INTRA_CHROMA, 1);
      int ci = 0;
      for (int k = 0; k < 4; k++)
        if (cand[k] == chroma_mode) ci = k;
      bac->bypass_bins(ci, 2);
    }

    int gx0 = x0 / 4, gy0 = y0 / 4;
    for (int yy = gy0; yy < gy0 + un; yy++)
      for (int xx = gx0; xx < gx0 + un; xx++) g_depth[yy * uw + xx] = depth;

    bool intra_split = part_nxn;
    int max_depth = p.max_tr_depth_intra + (intra_split ? 1 : 0);
    bac->cat = CAT_TT;
    transform_tree(x0, y0, x0, y0, log2_size, 0, 0, intra_split, max_depth,
                   true, true, true);
  }

  // --------------------------------------------------------- transform tree
  bool cbf(int x0, int y0, int log2_size, int c_idx) const {
    int size = 1 << log2_size;
    if (c_idx == 0) return any_coeff(m.cy, W, x0, y0, size);
    const int32_t* arr = c_idx == 1 ? m.ccb : m.ccr;
    return any_coeff(arr, W2, x0 / 2, y0 / 2, size);
  }

  void transform_tree(int x0, int y0, int xbase, int ybase, int log2_size,
                      int trafo_depth, int blk_idx, bool intra_split,
                      int max_depth, bool cbf_cb_parent, bool cbf_cr_parent,
                      bool is_intra) {
    const int max_tb = 5, min_tb = 2;
    bool split = m.tr_depth[U(x0, y0)] > trafo_depth;
    bool expl = log2_size <= max_tb && log2_size > min_tb &&
                trafo_depth < max_depth && !(intra_split && trafo_depth == 0);
    if (log2_size > max_tb || (intra_split && trafo_depth == 0))
      split = true;
    else if (log2_size == min_tb || trafo_depth == max_depth)
      split = false;
    bac->cat = CAT_TT;
    if (expl) bac->bin(OFF_TRANS_SUBDIV + (5 - log2_size), split);

    bool cbf_cb = false, cbf_cr = false;
    if (log2_size > 2) {
      cbf_cb = cbf(x0, y0, log2_size - 1, 1);
      cbf_cr = cbf(x0, y0, log2_size - 1, 2);
      if (trafo_depth == 0 || cbf_cb_parent)
        bac->bin(OFF_CBF_CHROMA + trafo_depth, cbf_cb);
      if (trafo_depth == 0 || cbf_cr_parent)
        bac->bin(OFF_CBF_CHROMA + trafo_depth, cbf_cr);
    } else {
      cbf_cb = cbf_cb_parent;
      cbf_cr = cbf_cr_parent;
    }

    if (split) {
      int half = 1 << (log2_size - 1);
      const int off[4][2] = {{0, 0}, {half, 0}, {0, half}, {half, half}};
      for (int i = 0; i < 4; i++)
        transform_tree(x0 + off[i][0], y0 + off[i][1], x0, y0, log2_size - 1,
                       trafo_depth + 1, i, intra_split, max_depth, cbf_cb,
                       cbf_cr, is_intra);
      return;
    }

    bool cbf_luma = cbf(x0, y0, log2_size, 0);
    bac->cat = CAT_TT;
    if (is_intra || trafo_depth != 0 || cbf_cb || cbf_cr)
      bac->bin(OFF_CBF_LUMA + (trafo_depth == 0 ? 1 : 0), cbf_luma);

    if (p.cu_qp_delta_enabled && !qg_coded && (cbf_luma || cbf_cb || cbf_cr)) {
      cu_qp_delta_bins(qg_target - qg_pred);
      qg_coded = true;
    }
    if (cbf_luma) residual(x0, y0, log2_size, 0);
    if (log2_size > 2) {
      if (cbf_cb) residual(x0, y0, log2_size - 1, 1);
      if (cbf_cr) residual(x0, y0, log2_size - 1, 2);
    } else if (blk_idx == 3) {
      if (cbf_cb) residual(xbase, ybase, 2, 1);
      if (cbf_cr) residual(xbase, ybase, 2, 2);
    }
  }

  // --------------------------------------------------------- residual coding
  void last_xy(int last_x, int last_y, int log2_size, int c_idx) {
    int ctx_offset, ctx_shift;
    if (c_idx == 0) {
      ctx_offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
      ctx_shift = (log2_size + 1) >> 2;
    } else {
      ctx_offset = 15;
      ctx_shift = log2_size - 2;
    }
    int cmax = (log2_size << 1) - 1;
    int gx = GROUP_IDX[last_x], gy = GROUP_IDX[last_y];
    for (int b = 0; b < gx; b++)
      bac->bin(OFF_LAST_X + ctx_offset + (b >> ctx_shift), 1);
    if (gx < cmax) bac->bin(OFF_LAST_X + ctx_offset + (gx >> ctx_shift), 0);
    for (int b = 0; b < gy; b++)
      bac->bin(OFF_LAST_Y + ctx_offset + (b >> ctx_shift), 1);
    if (gy < cmax) bac->bin(OFF_LAST_Y + ctx_offset + (gy >> ctx_shift), 0);
    if (gx > 3) bac->bypass_bins(last_x - MIN_IN_GROUP[gx], (gx >> 1) - 1);
    if (gy > 3) bac->bypass_bins(last_y - MIN_IN_GROUP[gy], (gy >> 1) - 1);
  }

  int sig_ctx(int pos, const int32_t* scan, int size, int log2_size, int c_idx,
              int scan_idx, const int32_t* csbf, int sx, int sy) const {
    int r = scan[pos];
    int xc = r % size, yc = r / size;
    int s;
    if (log2_size == 2) {
      s = SIG_CTX_4X4[(yc << 2) + xc];
    } else if (xc + yc == 0) {
      s = 0;
    } else {
      int nsb = size / 4;
      int right = sx + 1 < nsb ? csbf[sy * (nsb + 1) + sx + 1] : 0;
      int below = sy + 1 < nsb ? csbf[(sy + 1) * (nsb + 1) + sx] : 0;
      int prev = right + 2 * below;
      int xp = xc & 3, yp = yc & 3;
      if (prev == 0)
        s = xp + yp == 0 ? 2 : (xp + yp < 3 ? 1 : 0);
      else if (prev == 1)
        s = yp == 0 ? 2 : (yp == 1 ? 1 : 0);
      else if (prev == 2)
        s = xp == 0 ? 2 : (xp == 1 ? 1 : 0);
      else
        s = 2;
      if (c_idx == 0) {
        if (sx + sy > 0) s += 3;
        s += log2_size == 3 ? (scan_idx == 0 ? 9 : 15) : 21;
      } else {
        s += log2_size == 3 ? 9 : 12;
      }
    }
    return s + (c_idx ? 27 : 0);
  }

  void remaining(int value, int rice) {
    if ((value >> rice) < 3) {
      int q = value >> rice;
      bac->bypass_bins((1 << (q + 1)) - 2, q + 1);
      if (rice) bac->bypass_bins(value & ((1 << rice) - 1), rice);
    } else {
      value -= 3 << rice;
      int length = rice;
      while (value >= (1 << length)) {
        value -= 1 << length;
        length++;
      }
      int prefix_len = 3 + length + 1 - rice;
      bac->bypass_bins((1u << prefix_len) - 2, prefix_len);
      if (length) bac->bypass_bins(value, length);
    }
  }

  void residual(int x0, int y0, int log2_size, int c_idx) {
    int size = 1 << log2_size;
    const int32_t* arr;
    int stride, bx, by;
    int u = U(x0, y0);
    int pred_mode;
    bool cu_intra =
        p.slice_type == SLICE_I ||
        (m.pred_intra && m.pred_intra[u] && !(m.skip && m.skip[u]));
    if (c_idx == 0) {
      arr = m.cy;
      stride = W;
      bx = x0;
      by = y0;
      pred_mode = m.luma_mode[u];
    } else {
      arr = c_idx == 1 ? m.ccb : m.ccr;
      stride = W2;
      bx = x0 / 2;
      by = y0 / 2;
      pred_mode = m.chroma_mode[u];
      if (pred_mode == 34 || pred_mode == -1) pred_mode = m.luma_mode[u];
    }
    int scan_idx = cu_intra ? scan_mode_for_intra(log2_size, pred_mode, c_idx) : 0;
    const int32_t* scan = g_scans.coeff[log2_size - 2][scan_idx].data();
    bac->cat = CAT_LAST_XY;

    // gather coefficients in scan order
    int nn = size * size;
    int64_t in_scan[1024];
    int last_scan_pos = -1;
    for (int i = 0; i < nn; i++) {
      int rpos = scan[i];
      int32_t v = arr[(by + rpos / size) * stride + bx + rpos % size];
      in_scan[i] = v;
      if (v) last_scan_pos = i;
    }
    int last_r = scan[last_scan_pos];
    int last_x = last_r % size, last_y = last_r / size;
    if (scan_idx == 2) {
      int t = last_x;
      last_x = last_y;
      last_y = t;
    }
    last_xy(last_x, last_y, log2_size, c_idx);

    int last_sb = last_scan_pos / 16;
    int nsb_dim = size / 4 > 0 ? size / 4 : 1;
    const int32_t* sb_scan = g_scans.sub[log2_size - 2][scan_idx].data();
    std::vector<int32_t> csbf((nsb_dim + 1) * (nsb_dim + 1), 0);
    std::vector<uint8_t> sb_has(last_sb + 1, 0);
    for (int i = 0; i <= last_sb; i++) {
      for (int k = i * 16; k < (i + 1) * 16; k++)
        if (in_scan[k]) {
          sb_has[i] = 1;
          break;
        }
    }

    int c1 = 1;
    for (int i = last_sb; i >= 0; i--) {
      int sx = size > 4 ? sb_scan[2 * i] : 0;
      int sy = size > 4 ? sb_scan[2 * i + 1] : 0;
      bool infer_dc = false;
      if (i < last_sb && i > 0) {
        int right = sx + 1 < nsb_dim ? csbf[sy * (nsb_dim + 1) + sx + 1] : 0;
        int below = sy + 1 < nsb_dim ? csbf[(sy + 1) * (nsb_dim + 1) + sx] : 0;
        int ctx = (right + below > 0 ? 1 : 0) + (c_idx ? 2 : 0);
        bac->cat = CAT_SIG;
        bac->bin(OFF_SIG_CG + ctx, sb_has[i]);
        infer_dc = true;
      } else {
        sb_has[i] = 1;
      }
      csbf[sy * (nsb_dim + 1) + sx] = sb_has[i];
      if (!sb_has[i]) continue;

      int start = i == last_sb ? last_scan_pos - 1 - i * 16 : 15;
      int sig_pos[17], nsig = 0;
      if (i == last_sb) sig_pos[nsig++] = last_scan_pos;
      for (int n = start; n >= 0; n--) {
        int pos = i * 16 + n;
        int sig = in_scan[pos] != 0;
        if (n > 0 || !infer_dc) {
          int ctx = sig_ctx(pos, scan, size, log2_size, c_idx, scan_idx,
                            csbf.data(), sx, sy);
          bac->cat = CAT_SIG;
          bac->bin(OFF_SIG + ctx, sig);
          if (sig) infer_dc = false;
        }
        if (sig) sig_pos[nsig++] = pos;
      }
      if (nsig == 0) continue;  // DC subblock, csbf inferred, no sig coeffs

      int levels[17], signs[17];
      for (int k = 0; k < nsig; k++) {
        int64_t v = in_scan[sig_pos[k]];
        levels[k] = v < 0 ? (int)-v : (int)v;
        signs[k] = v < 0;
      }

      bac->cat = CAT_LEVEL;
      int ctx_set = ((i > 0 && c_idx == 0) ? 2 : 0) + (c1 == 0 ? 1 : 0);
      c1 = 1;
      int gt1_flags[8], first_gt1 = -1;
      int n1 = nsig < 8 ? nsig : 8;
      for (int k = 0; k < n1; k++) {
        int gt1 = levels[k] > 1;
        bac->bin(OFF_ONE + (c_idx ? 16 : 0) + 4 * ctx_set + c1, gt1);
        gt1_flags[k] = gt1;
        if (gt1) {
          c1 = 0;
          if (first_gt1 < 0) first_gt1 = k;
        } else if (c1 > 0 && c1 < 3) {
          c1++;
        }
      }
      int gt2 = 0;
      if (first_gt1 >= 0) {
        gt2 = levels[first_gt1] > 2;
        bac->bin(OFF_ABS + (c_idx ? 4 : 0) + ctx_set, gt2);
      }

      int first_sig = sig_pos[nsig - 1] - i * 16;
      int last_sig = sig_pos[0] - i * 16;
      bool sign_hidden = p.sign_hiding && (last_sig - first_sig > 3);
      for (int k = 0; k < nsig; k++) {
        if (sign_hidden && k == nsig - 1) continue;
        bac->bypass(signs[k]);
      }

      bac->cat = CAT_LEVEL;
      int rice = 0;
      for (int k = 0; k < nsig; k++) {
        int base_level, code_rem;
        if (k < 8) {
          if (k == first_gt1) {
            base_level = 2 + gt2;
            code_rem = gt2 == 1;
          } else if (gt1_flags[k]) {
            base_level = 2;
            code_rem = 1;
          } else {
            base_level = 1;
            code_rem = 0;
          }
        } else {
          base_level = 1;
          code_rem = 1;
        }
        if (code_rem) {
          remaining(levels[k] - base_level, rice);
          if (levels[k] > (3 << rice) && rice < 4) rice++;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Rebuild dense coefficient planes + the per-4x4-unit any-nonzero map from
// the chunk wire's compacted sub-block list (host twin of p_chunk._to4's
// flattening: luma blocks first in (H/4 x W/4) raster, then Cb, then Cr
// 4x4 blocks of the half-res planes). Replaces the numpy scatter + nz
// reduction on the per-frame host path (~14 ms -> <1 ms at 720p).
void henc_scatter_levels(const int32_t* idx, const int16_t* vals, int cnt,
                         int H, int W, int32_t* coeff_y, int32_t* coeff_cb,
                         int32_t* coeff_cr, uint8_t* nz_u) {
  int w4 = W >> 2, uw = w4, uh = H >> 2;
  int ny4 = (H >> 2) * (W >> 2);
  int w8 = W >> 3;
  int nc4 = (H >> 3) * (W >> 3);
  std::memset(coeff_y, 0, sizeof(int32_t) * (size_t)H * W);
  std::memset(coeff_cb, 0, sizeof(int32_t) * (size_t)(H / 2) * (W / 2));
  std::memset(coeff_cr, 0, sizeof(int32_t) * (size_t)(H / 2) * (W / 2));
  std::memset(nz_u, 0, (size_t)uh * uw);
  for (int i = 0; i < cnt; i++) {
    int k = idx[i];
    const int16_t* v = vals + (size_t)i * 16;
    int32_t* plane;
    int by, bx, stride;
    if (k < ny4) {
      plane = coeff_y; by = k / w4; bx = k % w4; stride = W;
      nz_u[by * uw + bx] = 1;
    } else {
      int j = k - ny4;
      if (j >= nc4) { j -= nc4; plane = coeff_cr; } else plane = coeff_cb;
      if (j >= nc4) continue;               // padding sentinel
      by = j / w8; bx = j % w8; stride = W / 2;
      int u0 = (by * 2) * uw + bx * 2;
      nz_u[u0] = nz_u[u0 + 1] = nz_u[u0 + uw] = nz_u[u0 + uw + 1] = 1;
    }
    int32_t* dst = plane + (size_t)(by * 4) * stride + bx * 4;
    for (int r = 0; r < 4; r++, dst += stride, v += 4) {
      dst[0] = v[0]; dst[1] = v[1]; dst[2] = v[2]; dst[3] = v[3];
    }
  }
}

// RD diagnostics: point the encoder at a N_BIT_CAT-element double array to
// accumulate exact fractional bits per syntax category (NULL to disable).
void henc_set_bit_probe(double* p) { g_cat_bits = p; }
int henc_bit_probe_ncat() { return N_BIT_CAT; }

// Encodes slice_data() for all CTUs in raster order. ctx_state / ctx_mps are
// the NUM_CTX initialised context arrays (computed by the Python side from
// the normative init tables). With sp->wpp, each CTU row becomes its own
// byte-aligned substream (entropy_coding_sync, spec 9.3.2.2 context sync
// from the above-right CTU) and substream_sizes[r] receives each row's RBSP
// byte count (pass NULL when wpp is 0). Returns the number of bytes written
// to out (or -1 if out_cap was too small).
int henc_encode_slice(const SliceParams* sp, const int8_t* depth,
                      const int8_t* luma_mode, const int8_t* chroma_mode,
                      const uint8_t* part_nxn, const int8_t* tr_depth,
                      const uint8_t* pred_intra, const uint8_t* skip,
                      const uint8_t* merge_flag, const int8_t* merge_idx,
                      const int32_t* mvd, const int8_t* mvp_idx,
                      const int32_t* coeff_y, const int32_t* coeff_cb,
                      const int32_t* coeff_cr, const int8_t* sao,
                      const int8_t* inter_dir, const int32_t* mvd1,
                      const int8_t* mvp_idx1,
                      uint8_t* ctx_state,
                      uint8_t* ctx_mps, uint8_t* out, int out_cap,
                      int32_t* substream_sizes,
                      const int8_t* qp_ctu) {
  BitWriter bw;
  Bac bac;
  bac.bw = &bw;
  bac.state = ctx_state;
  bac.mps = ctx_mps;
  Maps maps{depth,      luma_mode, chroma_mode, tr_depth, merge_idx, mvp_idx,
            qp_ctu,
            part_nxn,   pred_intra, skip,       merge_flag,
            mvd,        coeff_y,   coeff_cb,    coeff_cr,  sao,
            inter_dir,  mvd1,      mvp_idx1};
  SliceEnc enc(*sp, maps, &bac);
  enc.qp_prev = sp->slice_qp;
  int ctu = 1 << sp->ctu_log2;
  int nx = (sp->pic_width + ctu - 1) / ctu;
  int ny = (sp->pic_height + ctu - 1) / ctu;
  enc.sao_nx = nx;

  std::vector<uint8_t> init_state, init_mps, wpp_state(NUM_CTX),
      wpp_mps(NUM_CTX);
  bool have_snapshot = false;
  if (sp->wpp) {
    init_state.assign(ctx_state, ctx_state + NUM_CTX);
    init_mps.assign(ctx_mps, ctx_mps + NUM_CTX);
  }

  size_t row_start = 0;
  for (int r = 0; r < ny; r++) {
    if (sp->wpp && r > 0) {
      // context sync (spec 9.3.2.2): restore the snapshot taken after the
      // second CTU of the row above; re-init if it does not exist.
      if (nx > 1 && have_snapshot) {
        std::memcpy(ctx_state, wpp_state.data(), NUM_CTX);
        std::memcpy(ctx_mps, wpp_mps.data(), NUM_CTX);
      } else {
        std::memcpy(ctx_state, init_state.data(), NUM_CTX);
        std::memcpy(ctx_mps, init_mps.data(), NUM_CTX);
      }
      bac = Bac();
      bac.bw = &bw;
      bac.state = ctx_state;
      bac.mps = ctx_mps;
      enc.bac = &bac;
    }
    for (int c = 0; c < nx; c++) {
      bool last_in_slice = r == ny - 1 && c == nx - 1;
      enc.encode_ctu(c * ctu, r * ctu, last_in_slice);
      if (sp->wpp && c == 1) {
        std::memcpy(wpp_state.data(), ctx_state, NUM_CTX);
        std::memcpy(wpp_mps.data(), ctx_mps, NUM_CTX);
        have_snapshot = true;
      }
      if (sp->wpp && c == nx - 1 && !last_in_slice)
        bac.terminate(1);  // end_of_subset_one_bit
    }
    if (sp->wpp || r == ny - 1) bw.align_zero();
    if (sp->wpp && substream_sizes) {
      substream_sizes[r] = (int32_t)(bw.buf.size() - row_start);
      row_start = bw.buf.size();
    }
  }
  if ((int)bw.buf.size() > out_cap) return -1;
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  return (int)bw.buf.size();
}

// ---------------------------------------------------------------------------
// Inter merge/skip/AMVP decision walk over the variable-depth CU quadtree.
// Native twin of ops/inter_golden.py derive_tree_decisions (decoder-exact
// candidate derivation, spec 8.5.3.2.3 / 8.5.3.2.6; role of the reference's
// hmr_motion_inter.c:1937-2470) — the walk is sequential in decode order
// (each CU's candidates read previously coded CUs' motion), so it stays on
// the host; C++ removes the per-CU Python overhead from the frame loop.

namespace {

struct DecCtx {
  const int32_t* mv;    // (uh, uw, 2) motion field being built
  int32_t* fmv;         // output field mv
  int32_t* fref;        // output field ref (-2 uncoded, 0 inter)
  int uh, uw;

  // packed unit: ref<0 -> unavailable; else (mvx, mvy)
  inline bool inter_at(int x, int y, int32_t* mvxy) const {
    if (x < 0 || y < 0 || x >= uw * 4 || y >= uh * 4) return false;
    int ux = x >> 2, uy = y >> 2;
    if (fref[uy * uw + ux] < 0) return false;
    mvxy[0] = fmv[(uy * uw + ux) * 2];
    mvxy[1] = fmv[(uy * uw + ux) * 2 + 1];
    return true;
  }
};

inline int mv_bits_fx_c(int32_t dx, int32_t dy) {
  auto comp = [](int32_t c) {
    unsigned a = c < 0 ? -c : c;
    int bl = 0;
    while (a) { bl++; a >>= 1; }
    return 1 + 2 * bl;
  };
  return comp(dx) + comp(dy);
}

}  // namespace

// depth_u (uh,uw) i32, mv_u (uh,uw,2) i32, has_resid_u (uh,uw) u8 ->
// skip/merge (u8), merge_idx/mvp_idx (i8), mvd (i32 x2), all per unit.
int henc_derive_tree_decisions(const int32_t* depth_u, const int32_t* mv_u,
                               const uint8_t* has_resid_u, int uh, int uw,
                               int ctu_log2, int max_merge_cand,
                               uint8_t* skip_u, uint8_t* merge_u,
                               int8_t* midx_u, int8_t* mvp_u,
                               int32_t* mvd_u,
                               const uint8_t* pred_intra_u) {
  int W = uw * 4, H = uh * 4, ctu = 1 << ctu_log2;
  std::vector<int32_t> fmv(uh * uw * 2, 0), fref(uh * uw, -2);
  DecCtx cx{mv_u, fmv.data(), fref.data(), uh, uw};
  std::memset(skip_u, 0, uh * uw);
  std::memset(merge_u, 0, uh * uw);
  std::memset(midx_u, 0, uh * uw);
  std::memset(mvp_u, 0, uh * uw);
  std::memset(mvd_u, 0, sizeof(int32_t) * uh * uw * 2);

  // leaf: derive merge/AMVP exactly as the Python golden walk; intra
  // leaves (pred_intra) just mark their units unavailable for later
  // neighbors' candidate lists (spec: intra units are not inter-available)
  auto leaf = [&](int x0, int y0, int size) {
    int ux = x0 >> 2, uy = y0 >> 2, un = size >> 2;
    if (pred_intra_u && pred_intra_u[uy * uw + ux]) {
      for (int r = uy; r < uy + un; r++)
        for (int c = ux; c < ux + un; c++) fref[r * uw + c] = -1;
      return;
    }
    int32_t mvx = mv_u[(uy * uw + ux) * 2], mvy = mv_u[(uy * uw + ux) * 2 + 1];
    bool hr = false;
    for (int r = uy; r < uy + un && !hr; r++)
      for (int c = ux; c < ux + un; c++)
        if (has_resid_u[r * uw + c]) { hr = true; break; }

    // merge list (spatial A1/B1/B0/A0/B2 + zero fill)
    int32_t a1[2], b1[2], b0[2], a0[2], b2[2];
    bool ha1 = cx.inter_at(x0 - 1, y0 + size - 1, a1);
    bool hb1 = cx.inter_at(x0 + size - 1, y0 - 1, b1);
    bool hb0 = cx.inter_at(x0 + size, y0 - 1, b0);
    bool ha0 = cx.inter_at(x0 - 1, y0 + size, a0);
    bool hb2 = cx.inter_at(x0 - 1, y0 - 1, b2);
    int32_t cands[5][2];
    int nc = 0, n_spatial = 0;
    auto eq = [](const int32_t* p, const int32_t* q) {
      return p[0] == q[0] && p[1] == q[1];
    };
    if (ha1) { cands[nc][0] = a1[0]; cands[nc][1] = a1[1]; nc++; n_spatial++; }
    if (hb1) {
      n_spatial++;
      if (!ha1 || !eq(b1, a1)) { cands[nc][0] = b1[0]; cands[nc][1] = b1[1]; nc++; }
    }
    if (hb0) {
      n_spatial++;
      if (!hb1 || !eq(b0, b1)) { cands[nc][0] = b0[0]; cands[nc][1] = b0[1]; nc++; }
    }
    if (ha0) {
      n_spatial++;
      if (!ha1 || !eq(a0, a1)) { cands[nc][0] = a0[0]; cands[nc][1] = a0[1]; nc++; }
    }
    if (n_spatial != 4 && hb2 && (!ha1 || !eq(b2, a1)) && (!hb1 || !eq(b2, b1))) {
      cands[nc][0] = b2[0]; cands[nc][1] = b2[1]; nc++;
    }
    if (nc > max_merge_cand) nc = max_merge_cand;
    while (nc < max_merge_cand) { cands[nc][0] = 0; cands[nc][1] = 0; nc++; }

    int mi = -1;
    for (int i = 0; i < nc; i++)
      if (cands[i][0] == mvx && cands[i][1] == mvy) { mi = i; break; }

    if (mi >= 0) {
      for (int r = uy; r < uy + un; r++)
        for (int c = ux; c < ux + un; c++) {
          merge_u[r * uw + c] = 1;
          midx_u[r * uw + c] = (int8_t)mi;
          skip_u[r * uw + c] = hr ? 0 : 1;
        }
    } else {
      // AMVP (spec 8.5.3.2.6, one ref pic, no TMVP)
      int32_t mva[2], mvb[2];
      bool hma = cx.inter_at(x0 - 1, y0 + size, mva) ||
                 cx.inter_at(x0 - 1, y0 + size - 1, mva);
      bool hmb = cx.inter_at(x0 + size, y0 - 1, mvb) ||
                 cx.inter_at(x0 + size - 1, y0 - 1, mvb) ||
                 cx.inter_at(x0 - 1, y0 - 1, mvb);
      int32_t amvp[2][2] = {{0, 0}, {0, 0}};
      int na = 0;
      if (hma) { amvp[na][0] = mva[0]; amvp[na][1] = mva[1]; na++; }
      if (hmb && (!hma || mvb[0] != mva[0] || mvb[1] != mva[1])) {
        amvp[na][0] = mvb[0]; amvp[na][1] = mvb[1]; na++;
      }
      int bts0 = mv_bits_fx_c(mvx - amvp[0][0], mvy - amvp[0][1]);
      int bts1 = mv_bits_fx_c(mvx - amvp[1][0], mvy - amvp[1][1]);
      int k = bts0 <= bts1 ? 0 : 1;
      for (int r = uy; r < uy + un; r++)
        for (int c = ux; c < ux + un; c++) {
          mvp_u[r * uw + c] = (int8_t)k;
          mvd_u[(r * uw + c) * 2] = mvx - amvp[k][0];
          mvd_u[(r * uw + c) * 2 + 1] = mvy - amvp[k][1];
        }
    }
    for (int r = uy; r < uy + un; r++)
      for (int c = ux; c < ux + un; c++) {
        fmv.data()[(r * uw + c) * 2] = mvx;
        fmv.data()[(r * uw + c) * 2 + 1] = mvy;
        fref.data()[r * uw + c] = 0;
      }
  };

  // z-order walk per CTU (decode order)
  std::function<void(int, int, int, int)> walk = [&](int x0, int y0, int size,
                                                     int depth) {
    if (x0 >= W || y0 >= H) return;
    if (depth_u[(y0 >> 2) * uw + (x0 >> 2)] > depth) {
      int h = size >> 1;
      walk(x0, y0, h, depth + 1);
      walk(x0 + h, y0, h, depth + 1);
      walk(x0, y0 + h, h, depth + 1);
      walk(x0 + h, y0 + h, h, depth + 1);
      return;
    }
    leaf(x0, y0, size);
  };
  for (int y0 = 0; y0 < H; y0 += ctu)
    for (int x0 = 0; x0 < W; x0 += ctu) walk(x0, y0, ctu, 0);
  return 0;
}
}
