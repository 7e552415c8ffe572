// K7's gate programs as straight-line code, one op a line.
//
// Generated from kernels/bitserial_cas.py program_table(W) by
// program_header(); do not edit.  Regenerate with
//   PYTHONPATH=src python -m repro_torch.kernels.bitserial_cas
//
// cas_program<W>(a, b) states every gate of
// core/gates.build_cas_program(W) for one operand pair and leaves
// (min, max) in (a, b).  A row is a W-bit mask in a uint32_t,
// column c (column 0 the MSB) at bit W-1-c; every op writes a new
// named local, so a row reused by the program is a new register
// and the row file is never indexed.  Nothing here compares a
// with b.  nvcc compiles the gates' logic, not each gate: it
// merges a NOR with the NOT that reads it, folds runs of shifts
// and drops the closing COPYs, so a pair costs fewer instructions
// than the program has gates (chip_smoke.py counts them in the
// SASS).
#pragma once

#include <cstdint>

template <int W>
__device__ __forceinline__ void cas_program(uint32_t& a, uint32_t& b);

// W = 2: 21 ops on 15 rows
template <>
__device__ __forceinline__ void cas_program<2>(uint32_t& a, uint32_t& b) {
  constexpr uint32_t m = 0x3u;
  constexpr uint32_t r0 = 0u, r1 = m;  // the constant rows
  const uint32_t r2 = a & m, r3 = b & m;  // rows A and B
  const uint32_t o0 = ~(r2 | r3) & m;  // row 4: NOR nab = ~(A|B)
  const uint32_t o1 = r2 & r3;  // row 5: AND aab = A&B
  const uint32_t o2 = ~(o0 | o1) & m;  // row 6: NOR x = XOR(A,B)
  const uint32_t o3 = ~(o2 | r0) & m;  // row 7: NOT e = XNOR(A,B)
  const uint32_t o4 = ~(r3 | r0) & m;  // row 8: NOT nb = ~B
  const uint32_t o5 = ~(r2 | o4) & m;  // row 9: NOR l = ~A & B
  const uint32_t o6 = ((o3 & r1) >> 1) | (1u << 1);  // row 10: COPY t = e >> 1 (fill 1)
  const uint32_t o7 = o5 & o6;  // row 11: AND lt_i = l_i & P_i
  const uint32_t o8 = ((o7 & r1) >> 1) | (0u << 1);  // row 12: COPY final shift (W=2)
  const uint32_t o9 = ((~(o7 | o8) & m) & 1u) ? m : 0u;  // row 13: NOR ~s broadcast to all columns (G30)
  const uint32_t o10 = ~(o9 | r0) & m;  // row 14: NOT s = A<B (G31)
  const uint32_t o11 = ~(r2 | o9) & m;  // row 4: NOR u = NOR(A,~s)
  const uint32_t o12 = ~(r3 | o10) & m;  // row 5: NOR v = NOR(B,s)
  const uint32_t o13 = ~(o11 | o12) & m;  // row 6: NOR min = NOR(u,v)
  const uint32_t o14 = ~(r2 | o10) & m;  // row 7: NOR u2 = NOR(A,s)
  const uint32_t o15 = ~(r3 | o9) & m;  // row 8: NOR v2 = NOR(B,~s)
  const uint32_t o16 = ~(o14 | o15) & m;  // row 9: NOR max = NOR(u2,v2)
  const uint32_t o17 = o16 & r1;  // row 10: COPY stage max
  const uint32_t o18 = o13 & r1;  // row 11: COPY stage min
  const uint32_t o19 = o17 & r1;  // row 3: COPY max -> row B (c27)
  const uint32_t o20 = o18 & r1;  // row 2: COPY min -> row A (c28)
  a = o20;
  b = o19;
}

// W = 4: 28 ops on 22 rows
template <>
__device__ __forceinline__ void cas_program<4>(uint32_t& a, uint32_t& b) {
  constexpr uint32_t m = 0xFu;
  constexpr uint32_t r0 = 0u, r1 = m;  // the constant rows
  const uint32_t r2 = a & m, r3 = b & m;  // rows A and B
  const uint32_t o0 = ~(r2 | r3) & m;  // row 4: NOR nab = ~(A|B)
  const uint32_t o1 = r2 & r3;  // row 5: AND aab = A&B
  const uint32_t o2 = ~(o0 | o1) & m;  // row 6: NOR x = XOR(A,B)
  const uint32_t o3 = ~(o2 | r0) & m;  // row 7: NOT e = XNOR(A,B)
  const uint32_t o4 = ~(r3 | r0) & m;  // row 8: NOT nb = ~B
  const uint32_t o5 = ~(r2 | o4) & m;  // row 9: NOR l = ~A & B
  const uint32_t o6 = ((o3 & r1) >> 1) | (1u << 3);  // row 10: COPY t = e >> 1 (fill 1)
  const uint32_t o7 = ((o6 & r1) >> 1) | (1u << 3);  // row 11: COPY prefix shift r0
  const uint32_t o8 = o6 & o7;  // row 12: AND prefix and r0
  const uint32_t o9 = ((o8 & r1) >> 1) | (1u << 3);  // row 13: COPY prefix shift r1
  const uint32_t o10 = o8 & o9;  // row 14: AND prefix and r1
  const uint32_t o11 = o5 & o10;  // row 15: AND lt_i = l_i & P_i
  const uint32_t o12 = ((o11 & r1) >> 1) | (0u << 3);  // row 16: COPY or-reduce shift k0
  const uint32_t o13 = ~(o11 | o12) & m;  // row 17: NOR or-reduce nor k0
  const uint32_t o14 = ~(o13 | r0) & m;  // row 18: NOT or-reduce restore k0
  const uint32_t o15 = (((o14 & r1) >> 2) & 1u) ? m : 0u;  // row 19: COPY bcast interior column (movement d)
  const uint32_t o16 = ((~(o14 | o15) & m) & 1u) ? m : 0u;  // row 20: NOR ~s broadcast to all columns (G30)
  const uint32_t o17 = ~(o16 | r0) & m;  // row 21: NOT s = A<B (G31)
  const uint32_t o18 = ~(r2 | o16) & m;  // row 4: NOR u = NOR(A,~s)
  const uint32_t o19 = ~(r3 | o17) & m;  // row 5: NOR v = NOR(B,s)
  const uint32_t o20 = ~(o18 | o19) & m;  // row 6: NOR min = NOR(u,v)
  const uint32_t o21 = ~(r2 | o17) & m;  // row 7: NOR u2 = NOR(A,s)
  const uint32_t o22 = ~(r3 | o16) & m;  // row 8: NOR v2 = NOR(B,~s)
  const uint32_t o23 = ~(o21 | o22) & m;  // row 9: NOR max = NOR(u2,v2)
  const uint32_t o24 = o23 & r1;  // row 10: COPY stage max
  const uint32_t o25 = o20 & r1;  // row 11: COPY stage min
  const uint32_t o26 = o24 & r1;  // row 3: COPY max -> row B (c27)
  const uint32_t o27 = o25 & r1;  // row 2: COPY min -> row A (c28)
  a = o27;
  b = o26;
}

// W = 8: 40 ops on 34 rows
template <>
__device__ __forceinline__ void cas_program<8>(uint32_t& a, uint32_t& b) {
  constexpr uint32_t m = 0xFFu;
  constexpr uint32_t r0 = 0u, r1 = m;  // the constant rows
  const uint32_t r2 = a & m, r3 = b & m;  // rows A and B
  const uint32_t o0 = ~(r2 | r3) & m;  // row 4: NOR nab = ~(A|B)
  const uint32_t o1 = r2 & r3;  // row 5: AND aab = A&B
  const uint32_t o2 = ~(o0 | o1) & m;  // row 6: NOR x = XOR(A,B)
  const uint32_t o3 = ~(o2 | r0) & m;  // row 7: NOT e = XNOR(A,B)
  const uint32_t o4 = ~(r3 | r0) & m;  // row 8: NOT nb = ~B
  const uint32_t o5 = ~(r2 | o4) & m;  // row 9: NOR l = ~A & B
  const uint32_t o6 = ((o3 & r1) >> 1) | (1u << 7);  // row 10: COPY t = e >> 1 (fill 1)
  const uint32_t o7 = ((o6 & r1) >> 1) | (1u << 7);  // row 11: COPY prefix shift r0
  const uint32_t o8 = o6 & o7;  // row 12: AND prefix and r0
  const uint32_t o9 = ((o8 & r1) >> 1) | (1u << 7);  // row 13: COPY prefix shift r1
  const uint32_t o10 = o8 & o9;  // row 14: AND prefix and r1
  const uint32_t o11 = ((o10 & r1) >> 1) | (1u << 7);  // row 15: COPY prefix shift r2
  const uint32_t o12 = o10 & o11;  // row 16: AND prefix and r2
  const uint32_t o13 = ((o12 & r1) >> 1) | (1u << 7);  // row 17: COPY prefix shift r3
  const uint32_t o14 = o12 & o13;  // row 18: AND prefix and r3
  const uint32_t o15 = ((o14 & r1) >> 1) | (1u << 7);  // row 19: COPY prefix shift r4
  const uint32_t o16 = o14 & o15;  // row 20: AND prefix and r4
  const uint32_t o17 = ((o16 & r1) >> 1) | (1u << 7);  // row 21: COPY prefix shift r5
  const uint32_t o18 = o16 & o17;  // row 22: AND prefix and r5
  const uint32_t o19 = o5 & o18;  // row 23: AND lt_i = l_i & P_i
  const uint32_t o20 = ((o19 & r1) >> 1) | (0u << 7);  // row 24: COPY or-reduce shift k0
  const uint32_t o21 = ~(o19 | o20) & m;  // row 25: NOR or-reduce nor k0
  const uint32_t o22 = ~(o21 | r0) & m;  // row 26: NOT or-reduce restore k0
  const uint32_t o23 = ((o22 & r1) >> 1) | (0u << 7);  // row 27: COPY or-reduce shift k1
  const uint32_t o24 = ((o23 & r1) >> 1) | (0u << 7);  // row 28: COPY or-reduce shift k1
  const uint32_t o25 = ~(o22 | o24) & m;  // row 29: NOR or-reduce nor k1
  const uint32_t o26 = ~(o25 | r0) & m;  // row 30: NOT or-reduce restore k1
  const uint32_t o27 = (((o26 & r1) >> 4) & 1u) ? m : 0u;  // row 31: COPY bcast interior column (movement d)
  const uint32_t o28 = ((~(o26 | o27) & m) & 1u) ? m : 0u;  // row 32: NOR ~s broadcast to all columns (G30)
  const uint32_t o29 = ~(o28 | r0) & m;  // row 33: NOT s = A<B (G31)
  const uint32_t o30 = ~(r2 | o28) & m;  // row 4: NOR u = NOR(A,~s)
  const uint32_t o31 = ~(r3 | o29) & m;  // row 5: NOR v = NOR(B,s)
  const uint32_t o32 = ~(o30 | o31) & m;  // row 6: NOR min = NOR(u,v)
  const uint32_t o33 = ~(r2 | o29) & m;  // row 7: NOR u2 = NOR(A,s)
  const uint32_t o34 = ~(r3 | o28) & m;  // row 8: NOR v2 = NOR(B,~s)
  const uint32_t o35 = ~(o33 | o34) & m;  // row 9: NOR max = NOR(u2,v2)
  const uint32_t o36 = o35 & r1;  // row 10: COPY stage max
  const uint32_t o37 = o32 & r1;  // row 11: COPY stage min
  const uint32_t o38 = o36 & r1;  // row 3: COPY max -> row B (c27)
  const uint32_t o39 = o37 & r1;  // row 2: COPY min -> row A (c28)
  a = o39;
  b = o38;
}

// W = 16: 62 ops on 56 rows
template <>
__device__ __forceinline__ void cas_program<16>(uint32_t& a, uint32_t& b) {
  constexpr uint32_t m = 0xFFFFu;
  constexpr uint32_t r0 = 0u, r1 = m;  // the constant rows
  const uint32_t r2 = a & m, r3 = b & m;  // rows A and B
  const uint32_t o0 = ~(r2 | r3) & m;  // row 4: NOR nab = ~(A|B)
  const uint32_t o1 = r2 & r3;  // row 5: AND aab = A&B
  const uint32_t o2 = ~(o0 | o1) & m;  // row 6: NOR x = XOR(A,B)
  const uint32_t o3 = ~(o2 | r0) & m;  // row 7: NOT e = XNOR(A,B)
  const uint32_t o4 = ~(r3 | r0) & m;  // row 8: NOT nb = ~B
  const uint32_t o5 = ~(r2 | o4) & m;  // row 9: NOR l = ~A & B
  const uint32_t o6 = ((o3 & r1) >> 1) | (1u << 15);  // row 10: COPY t = e >> 1 (fill 1)
  const uint32_t o7 = ((o6 & r1) >> 1) | (1u << 15);  // row 11: COPY prefix shift r0
  const uint32_t o8 = o6 & o7;  // row 12: AND prefix and r0
  const uint32_t o9 = ((o8 & r1) >> 1) | (1u << 15);  // row 13: COPY prefix shift r1
  const uint32_t o10 = o8 & o9;  // row 14: AND prefix and r1
  const uint32_t o11 = ((o10 & r1) >> 1) | (1u << 15);  // row 15: COPY prefix shift r2
  const uint32_t o12 = o10 & o11;  // row 16: AND prefix and r2
  const uint32_t o13 = ((o12 & r1) >> 1) | (1u << 15);  // row 17: COPY prefix shift r3
  const uint32_t o14 = o12 & o13;  // row 18: AND prefix and r3
  const uint32_t o15 = ((o14 & r1) >> 1) | (1u << 15);  // row 19: COPY prefix shift r4
  const uint32_t o16 = o14 & o15;  // row 20: AND prefix and r4
  const uint32_t o17 = ((o16 & r1) >> 1) | (1u << 15);  // row 21: COPY prefix shift r5
  const uint32_t o18 = o16 & o17;  // row 22: AND prefix and r5
  const uint32_t o19 = ((o18 & r1) >> 1) | (1u << 15);  // row 23: COPY prefix shift r6
  const uint32_t o20 = o18 & o19;  // row 24: AND prefix and r6
  const uint32_t o21 = ((o20 & r1) >> 1) | (1u << 15);  // row 25: COPY prefix shift r7
  const uint32_t o22 = o20 & o21;  // row 26: AND prefix and r7
  const uint32_t o23 = ((o22 & r1) >> 1) | (1u << 15);  // row 27: COPY prefix shift r8
  const uint32_t o24 = o22 & o23;  // row 28: AND prefix and r8
  const uint32_t o25 = ((o24 & r1) >> 1) | (1u << 15);  // row 29: COPY prefix shift r9
  const uint32_t o26 = o24 & o25;  // row 30: AND prefix and r9
  const uint32_t o27 = ((o26 & r1) >> 1) | (1u << 15);  // row 31: COPY prefix shift r10
  const uint32_t o28 = o26 & o27;  // row 32: AND prefix and r10
  const uint32_t o29 = ((o28 & r1) >> 1) | (1u << 15);  // row 33: COPY prefix shift r11
  const uint32_t o30 = o28 & o29;  // row 34: AND prefix and r11
  const uint32_t o31 = ((o30 & r1) >> 1) | (1u << 15);  // row 35: COPY prefix shift r12
  const uint32_t o32 = o30 & o31;  // row 36: AND prefix and r12
  const uint32_t o33 = ((o32 & r1) >> 1) | (1u << 15);  // row 37: COPY prefix shift r13
  const uint32_t o34 = o32 & o33;  // row 38: AND prefix and r13
  const uint32_t o35 = o5 & o34;  // row 39: AND lt_i = l_i & P_i
  const uint32_t o36 = ((o35 & r1) >> 1) | (0u << 15);  // row 40: COPY or-reduce shift k0
  const uint32_t o37 = ~(o35 | o36) & m;  // row 41: NOR or-reduce nor k0
  const uint32_t o38 = ~(o37 | r0) & m;  // row 42: NOT or-reduce restore k0
  const uint32_t o39 = ((o38 & r1) >> 1) | (0u << 15);  // row 43: COPY or-reduce shift k1
  const uint32_t o40 = ((o39 & r1) >> 1) | (0u << 15);  // row 44: COPY or-reduce shift k1
  const uint32_t o41 = ~(o38 | o40) & m;  // row 45: NOR or-reduce nor k1
  const uint32_t o42 = ~(o41 | r0) & m;  // row 46: NOT or-reduce restore k1
  const uint32_t o43 = ((o42 & r1) >> 1) | (0u << 15);  // row 47: COPY or-reduce shift k2
  const uint32_t o44 = ((o43 & r1) >> 1) | (0u << 15);  // row 48: COPY or-reduce shift k2
  const uint32_t o45 = ((o44 & r1) >> 1) | (0u << 15);  // row 49: COPY or-reduce shift k2
  const uint32_t o46 = ((o45 & r1) >> 1) | (0u << 15);  // row 50: COPY or-reduce shift k2
  const uint32_t o47 = ~(o42 | o46) & m;  // row 51: NOR or-reduce nor k2
  const uint32_t o48 = ~(o47 | r0) & m;  // row 52: NOT or-reduce restore k2
  const uint32_t o49 = (((o48 & r1) >> 8) & 1u) ? m : 0u;  // row 53: COPY bcast interior column (movement d)
  const uint32_t o50 = ((~(o48 | o49) & m) & 1u) ? m : 0u;  // row 54: NOR ~s broadcast to all columns (G30)
  const uint32_t o51 = ~(o50 | r0) & m;  // row 55: NOT s = A<B (G31)
  const uint32_t o52 = ~(r2 | o50) & m;  // row 4: NOR u = NOR(A,~s)
  const uint32_t o53 = ~(r3 | o51) & m;  // row 5: NOR v = NOR(B,s)
  const uint32_t o54 = ~(o52 | o53) & m;  // row 6: NOR min = NOR(u,v)
  const uint32_t o55 = ~(r2 | o51) & m;  // row 7: NOR u2 = NOR(A,s)
  const uint32_t o56 = ~(r3 | o50) & m;  // row 8: NOR v2 = NOR(B,~s)
  const uint32_t o57 = ~(o55 | o56) & m;  // row 9: NOR max = NOR(u2,v2)
  const uint32_t o58 = o57 & r1;  // row 10: COPY stage max
  const uint32_t o59 = o54 & r1;  // row 11: COPY stage min
  const uint32_t o60 = o58 & r1;  // row 3: COPY max -> row B (c27)
  const uint32_t o61 = o59 & r1;  // row 2: COPY min -> row A (c28)
  a = o61;
  b = o60;
}

// W = 32: 104 ops on 98 rows
template <>
__device__ __forceinline__ void cas_program<32>(uint32_t& a, uint32_t& b) {
  constexpr uint32_t m = 0xFFFFFFFFu;
  constexpr uint32_t r0 = 0u, r1 = m;  // the constant rows
  const uint32_t r2 = a & m, r3 = b & m;  // rows A and B
  const uint32_t o0 = ~(r2 | r3) & m;  // row 4: NOR nab = ~(A|B)
  const uint32_t o1 = r2 & r3;  // row 5: AND aab = A&B
  const uint32_t o2 = ~(o0 | o1) & m;  // row 6: NOR x = XOR(A,B)
  const uint32_t o3 = ~(o2 | r0) & m;  // row 7: NOT e = XNOR(A,B)
  const uint32_t o4 = ~(r3 | r0) & m;  // row 8: NOT nb = ~B
  const uint32_t o5 = ~(r2 | o4) & m;  // row 9: NOR l = ~A & B
  const uint32_t o6 = ((o3 & r1) >> 1) | (1u << 31);  // row 10: COPY t = e >> 1 (fill 1)
  const uint32_t o7 = ((o6 & r1) >> 1) | (1u << 31);  // row 11: COPY prefix shift r0
  const uint32_t o8 = o6 & o7;  // row 12: AND prefix and r0
  const uint32_t o9 = ((o8 & r1) >> 1) | (1u << 31);  // row 13: COPY prefix shift r1
  const uint32_t o10 = o8 & o9;  // row 14: AND prefix and r1
  const uint32_t o11 = ((o10 & r1) >> 1) | (1u << 31);  // row 15: COPY prefix shift r2
  const uint32_t o12 = o10 & o11;  // row 16: AND prefix and r2
  const uint32_t o13 = ((o12 & r1) >> 1) | (1u << 31);  // row 17: COPY prefix shift r3
  const uint32_t o14 = o12 & o13;  // row 18: AND prefix and r3
  const uint32_t o15 = ((o14 & r1) >> 1) | (1u << 31);  // row 19: COPY prefix shift r4
  const uint32_t o16 = o14 & o15;  // row 20: AND prefix and r4
  const uint32_t o17 = ((o16 & r1) >> 1) | (1u << 31);  // row 21: COPY prefix shift r5
  const uint32_t o18 = o16 & o17;  // row 22: AND prefix and r5
  const uint32_t o19 = ((o18 & r1) >> 1) | (1u << 31);  // row 23: COPY prefix shift r6
  const uint32_t o20 = o18 & o19;  // row 24: AND prefix and r6
  const uint32_t o21 = ((o20 & r1) >> 1) | (1u << 31);  // row 25: COPY prefix shift r7
  const uint32_t o22 = o20 & o21;  // row 26: AND prefix and r7
  const uint32_t o23 = ((o22 & r1) >> 1) | (1u << 31);  // row 27: COPY prefix shift r8
  const uint32_t o24 = o22 & o23;  // row 28: AND prefix and r8
  const uint32_t o25 = ((o24 & r1) >> 1) | (1u << 31);  // row 29: COPY prefix shift r9
  const uint32_t o26 = o24 & o25;  // row 30: AND prefix and r9
  const uint32_t o27 = ((o26 & r1) >> 1) | (1u << 31);  // row 31: COPY prefix shift r10
  const uint32_t o28 = o26 & o27;  // row 32: AND prefix and r10
  const uint32_t o29 = ((o28 & r1) >> 1) | (1u << 31);  // row 33: COPY prefix shift r11
  const uint32_t o30 = o28 & o29;  // row 34: AND prefix and r11
  const uint32_t o31 = ((o30 & r1) >> 1) | (1u << 31);  // row 35: COPY prefix shift r12
  const uint32_t o32 = o30 & o31;  // row 36: AND prefix and r12
  const uint32_t o33 = ((o32 & r1) >> 1) | (1u << 31);  // row 37: COPY prefix shift r13
  const uint32_t o34 = o32 & o33;  // row 38: AND prefix and r13
  const uint32_t o35 = ((o34 & r1) >> 1) | (1u << 31);  // row 39: COPY prefix shift r14
  const uint32_t o36 = o34 & o35;  // row 40: AND prefix and r14
  const uint32_t o37 = ((o36 & r1) >> 1) | (1u << 31);  // row 41: COPY prefix shift r15
  const uint32_t o38 = o36 & o37;  // row 42: AND prefix and r15
  const uint32_t o39 = ((o38 & r1) >> 1) | (1u << 31);  // row 43: COPY prefix shift r16
  const uint32_t o40 = o38 & o39;  // row 44: AND prefix and r16
  const uint32_t o41 = ((o40 & r1) >> 1) | (1u << 31);  // row 45: COPY prefix shift r17
  const uint32_t o42 = o40 & o41;  // row 46: AND prefix and r17
  const uint32_t o43 = ((o42 & r1) >> 1) | (1u << 31);  // row 47: COPY prefix shift r18
  const uint32_t o44 = o42 & o43;  // row 48: AND prefix and r18
  const uint32_t o45 = ((o44 & r1) >> 1) | (1u << 31);  // row 49: COPY prefix shift r19
  const uint32_t o46 = o44 & o45;  // row 50: AND prefix and r19
  const uint32_t o47 = ((o46 & r1) >> 1) | (1u << 31);  // row 51: COPY prefix shift r20
  const uint32_t o48 = o46 & o47;  // row 52: AND prefix and r20
  const uint32_t o49 = ((o48 & r1) >> 1) | (1u << 31);  // row 53: COPY prefix shift r21
  const uint32_t o50 = o48 & o49;  // row 54: AND prefix and r21
  const uint32_t o51 = ((o50 & r1) >> 1) | (1u << 31);  // row 55: COPY prefix shift r22
  const uint32_t o52 = o50 & o51;  // row 56: AND prefix and r22
  const uint32_t o53 = ((o52 & r1) >> 1) | (1u << 31);  // row 57: COPY prefix shift r23
  const uint32_t o54 = o52 & o53;  // row 58: AND prefix and r23
  const uint32_t o55 = ((o54 & r1) >> 1) | (1u << 31);  // row 59: COPY prefix shift r24
  const uint32_t o56 = o54 & o55;  // row 60: AND prefix and r24
  const uint32_t o57 = ((o56 & r1) >> 1) | (1u << 31);  // row 61: COPY prefix shift r25
  const uint32_t o58 = o56 & o57;  // row 62: AND prefix and r25
  const uint32_t o59 = ((o58 & r1) >> 1) | (1u << 31);  // row 63: COPY prefix shift r26
  const uint32_t o60 = o58 & o59;  // row 64: AND prefix and r26
  const uint32_t o61 = ((o60 & r1) >> 1) | (1u << 31);  // row 65: COPY prefix shift r27
  const uint32_t o62 = o60 & o61;  // row 66: AND prefix and r27
  const uint32_t o63 = ((o62 & r1) >> 1) | (1u << 31);  // row 67: COPY prefix shift r28
  const uint32_t o64 = o62 & o63;  // row 68: AND prefix and r28
  const uint32_t o65 = ((o64 & r1) >> 1) | (1u << 31);  // row 69: COPY prefix shift r29
  const uint32_t o66 = o64 & o65;  // row 70: AND prefix and r29
  const uint32_t o67 = o5 & o66;  // row 71: AND lt_i = l_i & P_i
  const uint32_t o68 = ((o67 & r1) >> 1) | (0u << 31);  // row 72: COPY or-reduce shift k0
  const uint32_t o69 = ~(o67 | o68) & m;  // row 73: NOR or-reduce nor k0
  const uint32_t o70 = ~(o69 | r0) & m;  // row 74: NOT or-reduce restore k0
  const uint32_t o71 = ((o70 & r1) >> 1) | (0u << 31);  // row 75: COPY or-reduce shift k1
  const uint32_t o72 = ((o71 & r1) >> 1) | (0u << 31);  // row 76: COPY or-reduce shift k1
  const uint32_t o73 = ~(o70 | o72) & m;  // row 77: NOR or-reduce nor k1
  const uint32_t o74 = ~(o73 | r0) & m;  // row 78: NOT or-reduce restore k1
  const uint32_t o75 = ((o74 & r1) >> 1) | (0u << 31);  // row 79: COPY or-reduce shift k2
  const uint32_t o76 = ((o75 & r1) >> 1) | (0u << 31);  // row 80: COPY or-reduce shift k2
  const uint32_t o77 = ((o76 & r1) >> 1) | (0u << 31);  // row 81: COPY or-reduce shift k2
  const uint32_t o78 = ((o77 & r1) >> 1) | (0u << 31);  // row 82: COPY or-reduce shift k2
  const uint32_t o79 = ~(o74 | o78) & m;  // row 83: NOR or-reduce nor k2
  const uint32_t o80 = ~(o79 | r0) & m;  // row 84: NOT or-reduce restore k2
  const uint32_t o81 = ((o80 & r1) >> 1) | (0u << 31);  // row 85: COPY or-reduce shift k3
  const uint32_t o82 = ((o81 & r1) >> 1) | (0u << 31);  // row 86: COPY or-reduce shift k3
  const uint32_t o83 = ((o82 & r1) >> 1) | (0u << 31);  // row 87: COPY or-reduce shift k3
  const uint32_t o84 = ((o83 & r1) >> 1) | (0u << 31);  // row 88: COPY or-reduce shift k3
  const uint32_t o85 = ((o84 & r1) >> 1) | (0u << 31);  // row 89: COPY or-reduce shift k3
  const uint32_t o86 = ((o85 & r1) >> 1) | (0u << 31);  // row 90: COPY or-reduce shift k3
  const uint32_t o87 = ((o86 & r1) >> 1) | (0u << 31);  // row 91: COPY or-reduce shift k3
  const uint32_t o88 = ((o87 & r1) >> 1) | (0u << 31);  // row 92: COPY or-reduce shift k3
  const uint32_t o89 = ~(o80 | o88) & m;  // row 93: NOR or-reduce nor k3
  const uint32_t o90 = ~(o89 | r0) & m;  // row 94: NOT or-reduce restore k3
  const uint32_t o91 = (((o90 & r1) >> 16) & 1u) ? m : 0u;  // row 95: COPY bcast interior column (movement d)
  const uint32_t o92 = ((~(o90 | o91) & m) & 1u) ? m : 0u;  // row 96: NOR ~s broadcast to all columns (G30)
  const uint32_t o93 = ~(o92 | r0) & m;  // row 97: NOT s = A<B (G31)
  const uint32_t o94 = ~(r2 | o92) & m;  // row 4: NOR u = NOR(A,~s)
  const uint32_t o95 = ~(r3 | o93) & m;  // row 5: NOR v = NOR(B,s)
  const uint32_t o96 = ~(o94 | o95) & m;  // row 6: NOR min = NOR(u,v)
  const uint32_t o97 = ~(r2 | o93) & m;  // row 7: NOR u2 = NOR(A,s)
  const uint32_t o98 = ~(r3 | o92) & m;  // row 8: NOR v2 = NOR(B,~s)
  const uint32_t o99 = ~(o97 | o98) & m;  // row 9: NOR max = NOR(u2,v2)
  const uint32_t o100 = o99 & r1;  // row 10: COPY stage max
  const uint32_t o101 = o96 & r1;  // row 11: COPY stage min
  const uint32_t o102 = o100 & r1;  // row 3: COPY max -> row B (c27)
  const uint32_t o103 = o101 & r1;  // row 2: COPY min -> row A (c28)
  a = o103;
  b = o102;
}
