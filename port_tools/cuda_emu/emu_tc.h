// The inline-PTX helpers of csrc/mma_bf16.cuh, emulated: emulate.py
// puts these definitions in place of the real ones, inside namespace tc.
// cp.async copies run at the wait that retires their group, so a read
// that comes before its wait sees the poisoned tile, not the data. Each
// CUDA thread keeps its own groups, in its fiber's slot.
struct EmuCopy {
  void* dst;
  const void* src;
  int n, bytes;
};
struct EmuCopies {
  std::deque<std::vector<EmuCopy>> groups;
  std::vector<EmuCopy> open;
};
inline EmuCopies& emu_copies() {
  if (!g_fiber->slot) {
    g_fiber->slot = new EmuCopies;
    g_fiber->slot_free = [](void* p) { delete static_cast<EmuCopies*>(p); };
  }
  return *static_cast<EmuCopies*>(g_fiber->slot);
}

inline uint32_t smem_addr(const void*) { return 0; }

template <int BYTES>
inline void cp_async(void* dst, const void* src, bool pred) {
  emu_copies().open.push_back({dst, src, pred ? BYTES : 0, BYTES});
}

inline void cp_async_commit() {
  EmuCopies& c = emu_copies();
  c.groups.push_back(c.open);
  c.open.clear();
}

template <int N>
inline void cp_async_wait() {
  auto& groups = emu_copies().groups;
  while ((int)groups.size() > N) {
    for (auto& c : groups.front()) {
      if (c.n)
        std::memcpy(c.dst, c.src, c.bytes);
      else
        std::memset(c.dst, 0, c.bytes);
    }
    groups.pop_front();
  }
}

// ldmatrix .x4: lane l gives the address of row l % 8 of matrix l / 8;
// plain, lane l holds (row l / 4, cols 2 (l % 4), +1) of each matrix;
// .trans, (rows 2 (l % 4), +1, col l / 4)
inline void emu_ldsm(uint32_t (&r)[4], const void* p, bool trans) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  g_blk->slots[w][l][1] = (uint64_t)(uintptr_t)p;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    auto row = [&](int k) {
      return (const uint16_t*)(uintptr_t)g_blk->slots[w][i * 8 + k][1];
    };
    if (trans)
      r[i] = (uint32_t)row(2 * (l % 4))[l / 4] |
             ((uint32_t)row(2 * (l % 4) + 1)[l / 4] << 16);
    else
      r[i] = (uint32_t)row(l / 4)[2 * (l % 4)] |
             ((uint32_t)row(l / 4)[2 * (l % 4) + 1] << 16);
  }
  __syncwarp();
}
inline void ldsm_x4(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, false); }
inline void ldsm_x4_t(uint32_t (&r)[4], const void* p) { emu_ldsm(r, p, true); }

// mma.m16n8k16 bf16 -> f32 with the fragment layouts of the header note
inline void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                uint32_t b1) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  uint64_t* me = g_blk->slots[w][l];
  for (int i = 0; i < 4; ++i) me[2 + i] = a[i];
  me[6] = b0;
  me[7] = b1;
  __syncwarp();
  auto half = [](uint64_t word, int hi) {
    return __bfloat162float(
        {(uint16_t)(hi ? (uint32_t)word >> 16 : (uint32_t)word & 0xffff)});
  };
  auto A = [&](int row, int col) {  // 16 x 16
    const int lane = (row % 8) * 4 + (col % 8) / 2;
    const int reg = (row >= 8 ? 1 : 0) + (col >= 8 ? 2 : 0);
    return half(g_blk->slots[w][lane][2 + reg], col & 1);
  };
  auto B = [&](int row, int col) {  // 16 x 8
    const int lane = col * 4 + (row % 8) / 2;
    return half(g_blk->slots[w][lane][row >= 8 ? 7 : 6], row & 1);
  };
  const int g = l / 4, t = l % 4;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(k, col);
    out[e] = acc;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) c[e] = out[e];
}
