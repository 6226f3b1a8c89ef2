// Isosurface extraction: marching tetrahedra over a dense scalar grid.
//
// Replaces skimage.measure.marching_cubes used by the reference's surface
// export (utils/plots.py:127-241). Marching tetrahedra (6 tets per cube)
// needs no 256-case tables, produces watertight surfaces, and is trivially
// parallel; triangle counts are ~2x marching cubes, which is irrelevant for
// visualisation/export.
//
// C ABI for ctypes. Grid is [nx, ny, nz] C-order float32; vertices come back
// in grid-index coordinates (caller rescales).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct V3 { float x, y, z; };

// the 6 tetrahedra decomposition of a unit cube (corner indices 0..7,
// corner c = (x + (c&1), y + ((c>>1)&1), z + ((c>>2)&1)))
const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 3, 6}, {0, 3, 2, 6},
    {0, 2, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

inline V3 lerp(const V3 &a, const V3 &b, float fa, float fb, float iso) {
  float t = (fb - fa) != 0 ? (iso - fa) / (fb - fa) : 0.5f;
  if (t < 0) t = 0; if (t > 1) t = 1;
  return {a.x + t * (b.x - a.x), a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
}

}  // namespace

extern "C" {

// Returns the number of triangles written. Caller provides out buffers sized
// for max_tris triangles (9 floats each). If the surface needs more, the
// function returns the required count (call again with bigger buffers).
int64_t marching_tetrahedra(const float *grid, int nx, int ny, int nz,
                            float iso, float *out_verts, int64_t max_tris) {
  int64_t n_tris = 0;
  auto g = [&](int x, int y, int z) -> float {
    return grid[(int64_t)x * ny * nz + (int64_t)y * nz + z];
  };

  for (int x = 0; x < nx - 1; x++) {
    for (int y = 0; y < ny - 1; y++) {
      for (int z = 0; z < nz - 1; z++) {
        float f[8];
        V3 p[8];
        bool allPos = true, allNeg = true;
        for (int c = 0; c < 8; c++) {
          int cx = x + (c & 1), cy = y + ((c >> 1) & 1), cz = z + ((c >> 2) & 1);
          f[c] = g(cx, cy, cz);
          p[c] = {(float)cx, (float)cy, (float)cz};
          if (f[c] < iso) allPos = false; else allNeg = false;
        }
        if (allPos || allNeg) continue;

        for (int t = 0; t < 6; t++) {
          const int *T = TETS[t];
          int mask = 0;
          for (int k = 0; k < 4; k++)
            if (f[T[k]] < iso) mask |= 1 << k;
          if (mask == 0 || mask == 15) continue;

          // collect edge intersections for this tet case
          V3 tri[2][3];
          int nt = 0;
          auto edge = [&](int a, int b) {
            return lerp(p[T[a]], p[T[b]], f[T[a]], f[T[b]], iso);
          };
          switch (mask) {
            case 1: case 14: {
              V3 v0 = edge(0, 1), v1 = edge(0, 2), v2 = edge(0, 3);
              tri[0][0] = v0; tri[0][1] = v1; tri[0][2] = v2; nt = 1;
              break;
            }
            case 2: case 13: {
              V3 v0 = edge(1, 0), v1 = edge(1, 3), v2 = edge(1, 2);
              tri[0][0] = v0; tri[0][1] = v1; tri[0][2] = v2; nt = 1;
              break;
            }
            case 4: case 11: {
              V3 v0 = edge(2, 0), v1 = edge(2, 1), v2 = edge(2, 3);
              tri[0][0] = v0; tri[0][1] = v1; tri[0][2] = v2; nt = 1;
              break;
            }
            case 8: case 7: {
              V3 v0 = edge(3, 0), v1 = edge(3, 2), v2 = edge(3, 1);
              tri[0][0] = v0; tri[0][1] = v1; tri[0][2] = v2; nt = 1;
              break;
            }
            case 3: case 12: {
              V3 a0 = edge(0, 2), a1 = edge(0, 3), b0 = edge(1, 2), b1 = edge(1, 3);
              tri[0][0] = a0; tri[0][1] = a1; tri[0][2] = b0;
              tri[1][0] = b0; tri[1][1] = a1; tri[1][2] = b1; nt = 2;
              break;
            }
            case 5: case 10: {
              V3 a0 = edge(0, 1), a1 = edge(0, 3), b0 = edge(2, 1), b1 = edge(2, 3);
              tri[0][0] = a0; tri[0][1] = b0; tri[0][2] = a1;
              tri[1][0] = b0; tri[1][1] = b1; tri[1][2] = a1; nt = 2;
              break;
            }
            case 6: case 9: {
              V3 a0 = edge(1, 0), a1 = edge(1, 3), b0 = edge(2, 0), b1 = edge(2, 3);
              tri[0][0] = a0; tri[0][1] = a1; tri[0][2] = b0;
              tri[1][0] = b0; tri[1][1] = a1; tri[1][2] = b1; nt = 2;
              break;
            }
          }
          for (int k = 0; k < nt; k++) {
            if (n_tris < max_tris) {
              float *o = out_verts + n_tris * 9;
              for (int j = 0; j < 3; j++) {
                o[3 * j] = tri[k][j].x;
                o[3 * j + 1] = tri[k][j].y;
                o[3 * j + 2] = tri[k][j].z;
              }
            }
            n_tris++;
          }
        }
      }
    }
  }
  return n_tris;
}

}  // extern "C"
