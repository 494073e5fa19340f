// kani_native — native runtime components of kanirenderer_tpu.
//
// The device compute path is JAX/XLA/Pallas; this library provides the
// host-side hot loops and the embeddable C ABI, mirroring the role of the
// reference's native (Rust) layer:
//   * OBJ parsing (reference src/resources.rs:63-101 via tobj: triangulate
//     + single-index semantics) — the CPU-bound part of scene loads;
//   * per-vertex tangent/bitangent accumulation (the O(tris) hot loop,
//     reference src/resources.rs:204-245);
//   * Morton ordering of triangle centroids (the tile binner's chunk
//     layout, no reference analog);
//   * PNG encode (frame dumps; zlib, filter 0 — matches io/image.py);
//   * run_kanirenderer() C ABI (reference src/lib.rs:2174-2192) that
//     drives kanirenderer_tpu.api.run IN-PROCESS by embedding CPython via
//     dlopen(libpython) — the call blocks in the caller's process like the
//     reference's cdylib — with a python3 subprocess fallback (fixed argv,
//     args via env, no shell) when no libpython is present.
//
// Exposed via a plain C ABI consumed from Python with ctypes
// (kanirenderer_tpu/io/native.py) and from other languages directly.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <dlfcn.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Tangent/bitangent accumulation (reference src/resources.rs:204-245)
// ---------------------------------------------------------------------------

int kani_compute_tbn(const float* pos, const float* uv, const int32_t* idx,
                     int64_t n_verts, int64_t n_tris, float* out_tan,
                     float* out_bitan) {
    std::vector<float> counts(n_verts, 0.0f);
    std::memset(out_tan, 0, sizeof(float) * 3 * n_verts);
    std::memset(out_bitan, 0, sizeof(float) * 3 * n_verts);

    for (int64_t t = 0; t < n_tris; ++t) {
        const int32_t a = idx[t * 3], b = idx[t * 3 + 1], c = idx[t * 3 + 2];
        if (a < 0 || b < 0 || c < 0 || a >= n_verts || b >= n_verts ||
            c >= n_verts)
            continue;
        const float* p0 = pos + a * 3;
        const float* p1 = pos + b * 3;
        const float* p2 = pos + c * 3;
        const float* u0 = uv + a * 2;
        const float* u1 = uv + b * 2;
        const float* u2 = uv + c * 2;

        const float dp1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
        const float dp2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
        const float du1[2] = {u1[0] - u0[0], u1[1] - u0[1]};
        const float du2[2] = {u2[0] - u0[0], u2[1] - u0[1]};

        const float det = du1[0] * du2[1] - du1[1] * du2[0];
        float r = 0.0f;
        if (std::fabs(det) > 1e-20f) r = 1.0f / det;

        float tan[3], bit[3];
        for (int k = 0; k < 3; ++k) {
            tan[k] = (dp1[k] * du2[1] - dp2[k] * du1[1]) * r;
            bit[k] = (dp2[k] * du1[0] - dp1[k] * du2[0]) * -r;
        }
        const int32_t corners[3] = {a, b, c};
        for (int ci = 0; ci < 3; ++ci) {
            float* ot = out_tan + corners[ci] * 3;
            float* ob = out_bitan + corners[ci] * 3;
            for (int k = 0; k < 3; ++k) {
                ot[k] += tan[k];
                ob[k] += bit[k];
            }
            counts[corners[ci]] += 1.0f;
        }
    }
    for (int64_t v = 0; v < n_verts; ++v) {
        const float d = counts[v] > 0.0f ? 1.0f / counts[v] : 1.0f;
        for (int k = 0; k < 3; ++k) {
            out_tan[v * 3 + k] *= d;
            out_bitan[v * 3 + k] *= d;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Morton (Z-order) ordering of 3D centroids
// ---------------------------------------------------------------------------

static inline uint64_t spread10(uint64_t x) {
    x &= 0x3FFull;
    x = (x | (x << 16)) & 0x030000FFull;
    x = (x | (x << 8)) & 0x0300F00Full;
    x = (x | (x << 4)) & 0x030C30C3ull;
    x = (x | (x << 2)) & 0x09249249ull;
    return x;
}

int kani_morton_order(const float* centroids, int64_t n, int32_t* out_order) {
    if (n <= 0) return 0;
    float lo[3] = {centroids[0], centroids[1], centroids[2]};
    float hi[3] = {centroids[0], centroids[1], centroids[2]};
    for (int64_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::min(lo[k], centroids[i * 3 + k]);
            hi[k] = std::max(hi[k], centroids[i * 3 + k]);
        }
    float scale[3];
    for (int k = 0; k < 3; ++k)
        scale[k] = hi[k] > lo[k] ? 1023.0f / (hi[k] - lo[k]) : 0.0f;

    std::vector<std::pair<uint64_t, int32_t>> keys(n);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t q[3];
        for (int k = 0; k < 3; ++k) {
            float v = (centroids[i * 3 + k] - lo[k]) * scale[k];
            v = std::min(std::max(v, 0.0f), 1023.0f);
            q[k] = (uint64_t)v;
        }
        keys[i] = {spread10(q[0]) | (spread10(q[1]) << 1) |
                       (spread10(q[2]) << 2),
                   (int32_t)i};
    }
    std::stable_sort(keys.begin(), keys.end(),
                     [](const auto& a, const auto& b) {
                         return a.first < b.first;
                     });
    for (int64_t i = 0; i < n; ++i) out_order[i] = keys[i].second;
    return 0;
}

// ---------------------------------------------------------------------------
// OBJ parser (tobj-equivalent: triangulate + single-index;
// reference src/resources.rs:84-101)
// ---------------------------------------------------------------------------

struct KaniMesh {
    std::string name;
    std::vector<float> positions;  // V*3
    std::vector<float> texcoords;  // V*2
    std::vector<float> normals;    // V*3
    std::vector<int32_t> indices;  // T*3
    int32_t material_id = 0;
};

struct KaniObj {
    std::vector<KaniMesh> meshes;
    std::vector<std::string> material_names;  // usemtl order of appearance
    std::string mtllib;
};

struct VKey {
    int32_t p, t, n;
    bool operator==(const VKey& o) const {
        return p == o.p && t == o.t && n == o.n;
    }
};
struct VKeyHash {
    size_t operator()(const VKey& k) const {
        return ((size_t)(uint32_t)k.p * 73856093u) ^
               ((size_t)(uint32_t)k.t * 19349663u) ^
               ((size_t)(uint32_t)k.n * 83492791u);
    }
};

void* kani_obj_parse(const char* text, int64_t len) {
    auto* obj = new KaniObj();
    std::vector<float> P, T, N;
    std::unordered_map<std::string, int32_t> mat_index;
    int32_t cur_mat = -1;

    KaniMesh mesh;
    std::string mesh_name = "obj";
    std::unordered_map<VKey, int32_t, VKeyHash> vmap;
    std::vector<VKey> verts;

    auto flush = [&]() {
        if (!mesh.indices.empty()) {
            mesh.name = mesh_name;
            mesh.material_id = cur_mat < 0 ? 0 : cur_mat;
            mesh.positions.reserve(verts.size() * 3);
            for (const VKey& k : verts) {
                for (int j = 0; j < 3; ++j)
                    mesh.positions.push_back(
                        (k.p >= 0 && (size_t)(k.p * 3 + j) < P.size())
                            ? P[k.p * 3 + j] : 0.0f);
                for (int j = 0; j < 2; ++j)
                    mesh.texcoords.push_back(
                        (k.t >= 0 && (size_t)(k.t * 2 + j) < T.size())
                            ? T[k.t * 2 + j] : 0.0f);
                for (int j = 0; j < 3; ++j)
                    mesh.normals.push_back(
                        (k.n >= 0 && (size_t)(k.n * 3 + j) < N.size())
                            ? N[k.n * 3 + j] : 0.0f);
            }
            obj->meshes.push_back(std::move(mesh));
        }
        mesh = KaniMesh();
        vmap.clear();
        verts.clear();
    };

    const char* p = text;
    const char* end = text + len;
    auto skip_ws = [&](const char*& q) {
        while (q < end && (*q == ' ' || *q == '\t')) ++q;
    };

    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        const char* q = p;
        skip_ws(q);

        if (q + 1 < line_end && q[0] == 'v' &&
            (q[1] == ' ' || q[1] == '\t')) {
            q += 1;
            for (int k = 0; k < 3 && q < line_end; ++k) {
                char* e;
                P.push_back(strtof(q, &e));
                q = e;
            }
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't') {
            q += 2;
            for (int k = 0; k < 2 && q < line_end; ++k) {
                char* e;
                T.push_back(strtof(q, &e));
                q = e;
            }
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n') {
            q += 2;
            for (int k = 0; k < 3 && q < line_end; ++k) {
                char* e;
                N.push_back(strtof(q, &e));
                q = e;
            }
        } else if (q < line_end && q[0] == 'f') {
            q += 1;
            // Unbounded face valence (fan-triangulated below), matching the
            // Python parser — a fixed cap would silently drop geometry on
            // high-valence polygon meshes.
            static thread_local std::vector<int32_t> face;
            face.clear();
            size_t nf = 0;
            while (q < line_end) {
                skip_ws(q);
                if (q >= line_end) break;
                // parse p[/t[/n]]
                char* e;
                long pi = strtol(q, &e, 10);
                if (e == q) break;
                q = e;
                long ti = 0, ni = 0;
                bool has_t = false, has_n = false;
                if (q < line_end && *q == '/') {
                    ++q;
                    if (q < line_end && *q != '/') {
                        ti = strtol(q, &e, 10);
                        has_t = true;
                        q = e;
                    }
                    if (q < line_end && *q == '/') {
                        ++q;
                        ni = strtol(q, &e, 10);
                        has_n = true;
                        q = e;
                    }
                }
                VKey key;
                key.p = pi > 0 ? (int32_t)(pi - 1)
                               : (int32_t)(P.size() / 3 + pi);
                key.t = has_t ? (ti > 0 ? (int32_t)(ti - 1)
                                        : (int32_t)(T.size() / 2 + ti))
                              : -1;
                key.n = has_n ? (ni > 0 ? (int32_t)(ni - 1)
                                        : (int32_t)(N.size() / 3 + ni))
                              : -1;
                auto it = vmap.find(key);
                int32_t vid;
                if (it == vmap.end()) {
                    vid = (int32_t)verts.size();
                    vmap.emplace(key, vid);
                    verts.push_back(key);
                } else {
                    vid = it->second;
                }
                face.push_back(vid);
                ++nf;
            }
            for (size_t k = 1; k + 1 < nf; ++k) {  // fan triangulation
                mesh.indices.push_back(face[0]);
                mesh.indices.push_back(face[k]);
                mesh.indices.push_back(face[k + 1]);
            }
        } else if (line_end - q > 2 && (q[0] == 'o' || q[0] == 'g') &&
                   (q[1] == ' ' || q[1] == '\t')) {
            flush();
            const char* s = q + 2;
            skip_ws(s);
            mesh_name.assign(s, line_end - s);
            while (!mesh_name.empty() &&
                   (mesh_name.back() == '\r' || mesh_name.back() == ' '))
                mesh_name.pop_back();
        } else if (line_end - q > 7 && !strncmp(q, "usemtl", 6)) {
            const char* s = q + 6;
            skip_ws(s);
            std::string name(s, line_end - s);
            while (!name.empty() &&
                   (name.back() == '\r' || name.back() == ' '))
                name.pop_back();
            // Assign ids in order of first appearance; the host remaps
            // them to MTL slots by name (kani_obj_material_name).
            int32_t next;
            auto it = mat_index.find(name);
            if (it == mat_index.end()) {
                next = (int32_t)obj->material_names.size();
                mat_index.emplace(name, next);
                obj->material_names.push_back(name);
            } else {
                next = it->second;
            }
            if (next != cur_mat) flush();
            cur_mat = next;
        } else if (line_end - q > 7 && !strncmp(q, "mtllib", 6)) {
            const char* s = q + 6;
            skip_ws(s);
            obj->mtllib.assign(s, line_end - s);
            while (!obj->mtllib.empty() && (obj->mtllib.back() == '\r' ||
                                            obj->mtllib.back() == ' '))
                obj->mtllib.pop_back();
        }
        p = line_end + 1;
    }
    flush();
    return obj;
}

// Register material names (from the host-resolved MTL) so usemtl ids match.
// Call before kani_obj_parse via the two-phase API below, or remap after.
int kani_obj_mesh_count(void* h) {
    return (int)((KaniObj*)h)->meshes.size();
}

int64_t kani_obj_mesh_verts(void* h, int i) {
    return (int64_t)((KaniObj*)h)->meshes[i].positions.size() / 3;
}

int64_t kani_obj_mesh_tris(void* h, int i) {
    return (int64_t)((KaniObj*)h)->meshes[i].indices.size() / 3;
}

int kani_obj_mesh_material(void* h, int i) {
    return ((KaniObj*)h)->meshes[i].material_id;
}

const char* kani_obj_mtllib(void* h) { return ((KaniObj*)h)->mtllib.c_str(); }

int kani_obj_material_count(void* h) {
    return (int)((KaniObj*)h)->material_names.size();
}

const char* kani_obj_material_name(void* h, int i) {
    return ((KaniObj*)h)->material_names[i].c_str();
}

int kani_obj_mesh_copy(void* h, int i, float* pos, float* uv, float* nrm,
                       int32_t* idx) {
    const KaniMesh& m = ((KaniObj*)h)->meshes[i];
    std::memcpy(pos, m.positions.data(), m.positions.size() * sizeof(float));
    std::memcpy(uv, m.texcoords.data(), m.texcoords.size() * sizeof(float));
    std::memcpy(nrm, m.normals.data(), m.normals.size() * sizeof(float));
    std::memcpy(idx, m.indices.data(), m.indices.size() * sizeof(int32_t));
    return 0;
}

void kani_obj_free(void* h) { delete (KaniObj*)h; }

// ---------------------------------------------------------------------------
// PNG encode (filter 0, zlib) — identical output semantics to io/image.py
// ---------------------------------------------------------------------------

static void put32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back((x >> 24) & 0xFF);
    v.push_back((x >> 16) & 0xFF);
    v.push_back((x >> 8) & 0xFF);
    v.push_back(x & 0xFF);
}

static void chunk(std::vector<uint8_t>& out, const char tag[4],
                  const uint8_t* data, size_t n) {
    put32(out, (uint32_t)n);
    size_t start = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), data, data + n);
    uint32_t crc = crc32(0, out.data() + start, (uInt)(n + 4));
    put32(out, crc);
}

int kani_write_png(const char* path, const uint8_t* img, int w, int h,
                   int channels) {
    if (channels != 1 && channels != 3 && channels != 4) return -1;
    const uint8_t ctype = channels == 1 ? 0 : (channels == 3 ? 2 : 6);

    std::vector<uint8_t> raw;
    raw.reserve((size_t)h * (w * channels + 1));
    for (int y = 0; y < h; ++y) {
        raw.push_back(0);
        raw.insert(raw.end(), img + (size_t)y * w * channels,
                   img + (size_t)(y + 1) * w * channels);
    }
    uLongf clen = compressBound((uLong)raw.size());
    std::vector<uint8_t> comp(clen);
    if (compress2(comp.data(), &clen, raw.data(), (uLong)raw.size(), 6) !=
        Z_OK)
        return -2;
    comp.resize(clen);

    std::vector<uint8_t> out;
    const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    out.insert(out.end(), sig, sig + 8);
    uint8_t ihdr[13];
    ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
    ihdr[2] = (w >> 8) & 0xFF; ihdr[3] = w & 0xFF;
    ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
    ihdr[6] = (h >> 8) & 0xFF; ihdr[7] = h & 0xFF;
    ihdr[8] = 8; ihdr[9] = ctype; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
    chunk(out, "IHDR", ihdr, 13);
    chunk(out, "IDAT", comp.data(), comp.size());
    chunk(out, "IEND", nullptr, 0);

    FILE* f = fopen(path, "wb");
    if (!f) return -3;
    fwrite(out.data(), 1, out.size(), f);
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// Embeddable app entry (reference src/lib.rs:2174-2192): drive the renderer
// from C/Go hosts.  Two execution paths:
//
//  1. IN-PROCESS (default, like the reference whose dylib runs the event
//     loop in the caller's process): dlopen() the CPython runtime, embed an
//     interpreter, and PyRun the renderer in this process — the call blocks
//     until the render loop exits, exactly like run() (src/lib.rs:2054).
//     dlopen (instead of linking -lpython) keeps libkani_native.so free of
//     a hard libpython dependency for hosts that never call this entry.
//  2. SUBPROCESS fallback (KANI_EMBED=subprocess, or when no libpython is
//     found): fork + execvp of python3 with a FIXED argv.
//
// Either way arguments travel through KANI_ARG_* environment variables, so
// no caller string can ever be interpreted as code.
// ---------------------------------------------------------------------------

static const char kProgram[] =
    "import os, sys\n"
    "sys.path.insert(0, '.')\n"
    "if os.environ.get('KANI_PYTHONPATH'):\n"
    "    sys.path[:0] = os.environ['KANI_PYTHONPATH'].split(os.pathsep)\n"
    "import kanirenderer_tpu.api as api\n"
    "api.run(file_path=os.environ['KANI_ARG_FILE_PATH'],\n"
    "        file_type=os.environ['KANI_ARG_FILE_TYPE'],\n"
    "        fullscreen_mode=os.environ['KANI_ARG_FULLSCREEN'],\n"
    "        use_hdr=os.environ['KANI_ARG_HDR'] == '1')\n";

static int run_in_process() {
    // The soname list covers current CPython releases; RTLD_GLOBAL is
    // required so native extension modules (numpy, jaxlib) imported by the
    // embedded interpreter can resolve libpython symbols.
    static const char* kLibs[] = {
        "libpython3.13.so.1.0", "libpython3.12.so.1.0",
        "libpython3.11.so.1.0", "libpython3.10.so.1.0",
        "libpython3.so", nullptr};
    void* lib = nullptr;
    for (int i = 0; kLibs[i] && !lib; ++i)
        lib = dlopen(kLibs[i], RTLD_NOW | RTLD_GLOBAL);
    if (!lib) return -1000;  // caller falls back to the subprocess path

    auto py_is_init = (int (*)())dlsym(lib, "Py_IsInitialized");
    auto py_init = (void (*)())dlsym(lib, "Py_Initialize");
    auto py_run = (int (*)(const char*))dlsym(lib, "PyRun_SimpleString");
    if (!py_is_init || !py_init || !py_run) return -1000;

    if (!py_is_init()) py_init();
    // The interpreter is deliberately NOT finalized: repeated embed calls
    // reuse it (Python C API recommends against re-init after finalize
    // when native extensions like numpy are loaded).
    return py_run(kProgram) == 0 ? 0 : 1;
}

int run_kanirenderer(const char* file_path, const char* file_type,
                     const char* fullscreen_mode, int use_hdr) {
    // Arguments via environment — immune to quoting/injection.
    setenv("KANI_ARG_FILE_PATH", file_path ? file_path : "", 1);
    setenv("KANI_ARG_FILE_TYPE", file_type ? file_type : "opengl", 1);
    setenv("KANI_ARG_FULLSCREEN",
           fullscreen_mode ? fullscreen_mode : "windowed", 1);
    setenv("KANI_ARG_HDR", use_hdr ? "1" : "0", 1);

    const char* embed_mode = getenv("KANI_EMBED");
    if (!embed_mode || strcmp(embed_mode, "subprocess") != 0) {
        int rc = run_in_process();
        if (rc != -1000) return rc;  // ran (or failed) in-process
    }

    pid_t pid = fork();
    if (pid < 0) return -1;
    if (pid == 0) {
        const char* argv[] = {"python3", "-c", kProgram, nullptr};
        execvp("python3", const_cast<char* const*>(argv));
        _exit(127);  // execvp failed
    }
    int status = 0;
    if (waitpid(pid, &status, 0) < 0) return -1;
    if (WIFEXITED(status)) return WEXITSTATUS(status);
    return -1;
}

}  // extern "C"
