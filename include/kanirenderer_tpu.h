/* kanirenderer_tpu C ABI — the embeddable surface of the renderer.
 *
 * Mirrors the reference's cbindgen-generated header
 * (kanirenderer_viewer.h): link libkani_native.so and call
 * run_kanirenderer() to drive the renderer from C/Go hosts, plus the
 * native geometry/IO helpers used by the Python package itself.
 */
#ifndef KANIRENDERER_TPU_H
#define KANIRENDERER_TPU_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* App entry (reference src/lib.rs:2174-2192).
 * file_type: "opengl" | "default"; fullscreen_mode: "windowed" | "fullscreen".
 */
int run_kanirenderer(const char* file_path, const char* file_type,
                     const char* fullscreen_mode, int use_hdr);

/* Geometry hot loops */
int kani_compute_tbn(const float* pos, const float* uv, const int32_t* idx,
                     int64_t n_verts, int64_t n_tris, float* out_tan,
                     float* out_bitan);
int kani_morton_order(const float* centroids, int64_t n, int32_t* out_order);

/* OBJ parser (triangulating, single-index) */
void* kani_obj_parse(const char* text, int64_t len);
int kani_obj_mesh_count(void* handle);
int64_t kani_obj_mesh_verts(void* handle, int mesh);
int64_t kani_obj_mesh_tris(void* handle, int mesh);
int kani_obj_mesh_material(void* handle, int mesh);
int kani_obj_material_count(void* handle);
const char* kani_obj_material_name(void* handle, int material);
const char* kani_obj_mtllib(void* handle);
int kani_obj_mesh_copy(void* handle, int mesh, float* positions, float* uvs,
                       float* normals, int32_t* indices);
void kani_obj_free(void* handle);

/* Frame IO */
int kani_write_png(const char* path, const uint8_t* image, int width,
                   int height, int channels);

#ifdef __cplusplus
}
#endif

#endif /* KANIRENDERER_TPU_H */
