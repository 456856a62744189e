// dbat_native: host-side native helpers for dbat_tpu_torch (the port's
// copy of native/dbat_native.cpp; host code, not device kernels).
//
// C++ re-design of the reference's C MEX layer
// (code/test/postcov/icpc_mex.c, diagblkouter.c, extractdiagblocks.c;
// code/file/loadimagepts.m performance path):
//
//   parse_numeric_table : fast text -> double matrix parser for the
//       measurement/point table loaders (the reference sped this up
//       "some orders of magnitude" in v0.9.1.3 — ChangeLog.txt:14-16).
//   diag_block_outer    : diagonal n x n blocks of B' * A * B for a
//       dense symmetric A and tall B (diagblkouter.c equivalent) —
//       the building block of Schur-based covariance extraction.
//   batch_inv3          : batched 3x3 inverses (point-block solves).
//   icpc_blocks         : per-point 3x3 posterior covariance blocks
//       COP_j = Vinv_j + Vinv_j (Y_j' Y_j) Vinv_j given precomputed
//       Y columns (icpc_mex.c equivalent; a host form of the point
//       blocks of the solver's covariance).
//   png_unfilter        : undo the per-row filters of a decompressed
//       PNG image (io/png.py; the Average and Paeth filters are a
//       per-pixel recurrence along each row).
//
// Exposed with a plain C ABI for ctypes (no pybind11 needed).
// Built at first use by the port's io/native.py with the host compiler
// (g++ -O2 -shared -fPIC) into the package's _build/ directory.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// parse_numeric_table: parse a text file of numeric rows.
//   - skips blank lines and lines starting with comment_char
//   - accepts ',' and whitespace as separators
//   - first data row determines the column count
// Returns number of rows parsed, or -1 on error.  The data is written
// to out (caller-allocated, max_rows * ncols_expected doubles); the
// column count is written to *ncols_out.
// ---------------------------------------------------------------------------
long parse_numeric_table(const char* path, char comment_char,
                         double* out, long max_rows, long ncols_expected,
                         long* ncols_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(sz + 1);
    if (fread(buf.data(), 1, sz, f) != (size_t)sz) {
        fclose(f);
        return -1;
    }
    fclose(f);
    buf[sz] = '\0';

    long ncols = ncols_expected;
    long row = 0;
    char* p = buf.data();
    char* end = buf.data() + sz;
    while (p < end && row < max_rows) {
        // find line end
        char* eol = (char*)memchr(p, '\n', end - p);
        if (!eol) eol = end;
        *eol = '\0';
        // skip leading spaces
        char* q = p;
        while (*q == ' ' || *q == '\t' || *q == '\r') q++;
        if (*q != '\0' && *q != comment_char) {
            long col = 0;
            char* cur = q;
            while (*cur != '\0') {
                char* next = cur;
                double v = strtod(cur, &next);
                if (next == cur) break;  // no more numbers
                if (ncols < 0 || col < ncols) {
                    out[row * (ncols < 0 ? 64 : ncols) + col] = v;
                }
                col++;
                cur = next;
                while (*cur == ',' || *cur == ' ' || *cur == '\t' ||
                       *cur == '\r')
                    cur++;
            }
            if (col > 0) {
                if (ncols < 0) ncols = col;
                if (col != ncols) return -2 - row;  // ragged row
                row++;
            }
        }
        p = eol + 1;
    }
    *ncols_out = ncols;
    return row;
}

// ---------------------------------------------------------------------------
// diag_block_outer: C[j] = B_j' * A * B_j for each of m column blocks
// B_j = B[:, j*n:(j+1)*n].  A is (k,k) row-major symmetric, B is (k,
// m*n) row-major.  Out: m blocks of (n,n) row-major.
// Ref: code/test/postcov/diagblkouter.c
// ---------------------------------------------------------------------------
void diag_block_outer(const double* A, const double* B, long k, long m,
                      long n, double* out) {
    std::vector<double> AB(k * n);
    for (long j = 0; j < m; j++) {
        const long off = j * n;
        // AB = A * B_j  (k x n)
        for (long r = 0; r < k; r++) {
            for (long c = 0; c < n; c++) {
                double acc = 0;
                const double* arow = A + r * k;
                for (long t = 0; t < k; t++)
                    acc += arow[t] * B[t * (m * n) + off + c];
                AB[r * n + c] = acc;
            }
        }
        // out_j = B_j' * AB  (n x n)
        for (long r = 0; r < n; r++) {
            for (long c = 0; c < n; c++) {
                double acc = 0;
                for (long t = 0; t < k; t++)
                    acc += B[t * (m * n) + off + r] * AB[t * n + c];
                out[j * n * n + r * n + c] = acc;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// batch_inv3: invert m 3x3 matrices (row-major, contiguous).
// Returns 0 on success, index+1 of first singular block otherwise.
// ---------------------------------------------------------------------------
long batch_inv3(const double* A, long m, double* out) {
    for (long j = 0; j < m; j++) {
        const double* a = A + 9 * j;
        double c00 = a[4] * a[8] - a[5] * a[7];
        double c01 = a[5] * a[6] - a[3] * a[8];
        double c02 = a[3] * a[7] - a[4] * a[6];
        double det = a[0] * c00 + a[1] * c01 + a[2] * c02;
        if (det == 0.0) return j + 1;
        double id = 1.0 / det;
        double* o = out + 9 * j;
        o[0] = c00 * id;
        o[1] = (a[2] * a[7] - a[1] * a[8]) * id;
        o[2] = (a[1] * a[5] - a[2] * a[4]) * id;
        o[3] = c01 * id;
        o[4] = (a[0] * a[8] - a[2] * a[6]) * id;
        o[5] = (a[2] * a[3] - a[0] * a[5]) * id;
        o[6] = c02 * id;
        o[7] = (a[1] * a[6] - a[0] * a[7]) * id;
        o[8] = (a[0] * a[4] - a[1] * a[3]) * id;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// icpc_blocks: COP_j = s2 * (Vinv_j + Vinv_j * G_j * Vinv_j) with
// G_j = Y_j' * Y_j, where Y (k x 3m, row-major) holds the reduced-
// system backsolved columns of point j at columns 3j..3j+2.
// Ref: code/test/postcov/icpc_mex.c (inverse-Cholesky post-covariance)
// ---------------------------------------------------------------------------
void icpc_blocks(const double* Vinv, const double* Y, long k, long m,
                 double s2, double* out) {
    for (long j = 0; j < m; j++) {
        double G[9];
        for (long r = 0; r < 3; r++)
            for (long c = 0; c < 3; c++) {
                double acc = 0;
                for (long t = 0; t < k; t++)
                    acc += Y[t * (3 * m) + 3 * j + r] *
                           Y[t * (3 * m) + 3 * j + c];
                G[r * 3 + c] = acc;
            }
        const double* V = Vinv + 9 * j;
        double VG[9];
        for (long r = 0; r < 3; r++)
            for (long c = 0; c < 3; c++)
                VG[r * 3 + c] = V[r * 3] * G[c] + V[r * 3 + 1] * G[3 + c] +
                                V[r * 3 + 2] * G[6 + c];
        for (long r = 0; r < 3; r++)
            for (long c = 0; c < 3; c++) {
                double acc = V[r * 3 + c];
                acc += VG[r * 3] * V[c] + VG[r * 3 + 1] * V[3 + c] +
                       VG[r * 3 + 2] * V[6 + c];
                out[j * 9 + r * 3 + c] = s2 * acc;
            }
    }
}

// ---------------------------------------------------------------------------
// png_unfilter: PNG filter types 0-4 (PNG spec, section 9).  data holds
// h rows of 1 + stride bytes, the row's filter type first; bpp is the
// number of bytes of one pixel (at least 1).  The unfiltered rows go to
// out (h * stride bytes).  Returns 0, or 1 + the first row whose filter
// type is unknown.
// ---------------------------------------------------------------------------
long png_unfilter(const uint8_t* data, long h, long stride, long bpp,
                  uint8_t* out) {
    for (long r = 0; r < h; r++) {
        const uint8_t* f = data + r * (stride + 1) + 1;
        uint8_t* o = out + r * stride;
        const uint8_t* up = r > 0 ? o - stride : nullptr;
        const int type = f[-1];
        for (long i = 0; i < stride; i++) {
            const int a = i >= bpp ? o[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int pred;
            switch (type) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b),
                              pc = std::abs(p - c);
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return r + 1;
            }
            o[i] = static_cast<uint8_t>(f[i] + pred);
        }
    }
    return 0;
}

}  // extern "C"
