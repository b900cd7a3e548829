// sr_runtime: the native host runtime of software_renderer_tpu_torch.
//
// Host-side work around the device path: asset ingestion (OBJ parsing)
// and frame export (PNG encoding), in C++ for bulk throughput, behind a
// minimal C ABI consumed through ctypes (runtime/__init__.py), which
// builds this file with g++ at first use. A copy of the JAX package's
// runtime source: the same file gives the same arrays and bytes in both
// packages. Pure-Python counterparts: models/obj.py, utils/image_io.py.
//
// Build: g++ -O3 -shared -fPIC sr_runtime.cpp -o libsr_runtime.so -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG encoding (8-bit, RGB/RGBA/gray, filter 0) — zlib-deflated in one shot.
// ---------------------------------------------------------------------------

static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
    out.push_back(v >> 24); out.push_back(v >> 16);
    out.push_back(v >> 8); out.push_back(v);
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t n) {
    put_be32(out, (uint32_t)n);
    size_t start = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), data, data + n);
    uint32_t crc = crc32(0, out.data() + start, (uInt)(n + 4));
    put_be32(out, crc);
}

// Returns 0 on success.
int sr_write_png(const char* path, const uint8_t* pixels, int32_t width,
                 int32_t height, int32_t channels) {
    if (channels != 1 && channels != 3 && channels != 4) return -2;
    const uint8_t color_type = channels == 1 ? 0 : (channels == 3 ? 2 : 6);
    const size_t stride = (size_t)width * channels;

    // Raw scanlines with filter byte 0.
    std::vector<uint8_t> raw((stride + 1) * height);
    for (int32_t y = 0; y < height; ++y) {
        raw[(stride + 1) * y] = 0;
        memcpy(&raw[(stride + 1) * y + 1], pixels + stride * y, stride);
    }
    uLongf comp_cap = compressBound((uLong)raw.size());
    std::vector<uint8_t> comp(comp_cap);
    if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 6)
        != Z_OK)
        return -3;

    std::vector<uint8_t> out;
    static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                     0x1a, '\n'};
    out.insert(out.end(), magic, magic + 8);
    uint8_t ihdr[13];
    ihdr[0] = width >> 24; ihdr[1] = width >> 16;
    ihdr[2] = width >> 8; ihdr[3] = width;
    ihdr[4] = height >> 24; ihdr[5] = height >> 16;
    ihdr[6] = height >> 8; ihdr[7] = height;
    ihdr[8] = 8; ihdr[9] = color_type; ihdr[10] = 0; ihdr[11] = 0;
    ihdr[12] = 0;
    put_chunk(out, "IHDR", ihdr, 13);
    put_chunk(out, "IDAT", comp.data(), comp_cap);
    put_chunk(out, "IEND", nullptr, 0);

    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    size_t written = fwrite(out.data(), 1, out.size(), f);
    fclose(f);
    return written == out.size() ? 0 : -4;
}

// ---------------------------------------------------------------------------
// OBJ parsing. Two-phase C ABI: load -> query counts -> fill -> free.
// Faces are fan-triangulated; v/vt/vn triplets dedup to a unified vertex
// array (same contract as models/obj.py, which golden-tests against this).
// ---------------------------------------------------------------------------

struct ObjMesh {
    std::vector<float> positions;  // 3 per vertex
    std::vector<float> normals;    // 3 per vertex
    std::vector<float> uvs;        // 2 per vertex
    std::vector<int32_t> indices;  // 3 per triangle
};

static int32_t resolve_index(long idx, size_t count) {
    return idx > 0 ? (int32_t)(idx - 1) : (int32_t)((long)count + idx);
}

void* sr_obj_load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    std::vector<float> vs, vts, vns;
    auto* mesh = new ObjMesh();
    // Dedup keyed on the *resolved* (v, vt, vn) triple — negative
    // (relative) indices resolve differently as more records stream in,
    // so the raw token text is not a stable key (matches models/obj.py).
    std::unordered_map<uint64_t, int32_t> dedup;
    char line[4096];
    bool ok = true;  // any out-of-range face index poisons the whole load

    auto corner = [&](const char* tok) -> int32_t {
        long vi = 0, ti = 0, ni = 0;
        bool has_t = false, has_n = false;
        const char* p = tok;
        vi = strtol(p, (char**)&p, 10);
        if (*p == '/') {
            ++p;
            if (*p != '/') { ti = strtol(p, (char**)&p, 10); has_t = true; }
            if (*p == '/') { ++p; ni = strtol(p, (char**)&p, 10); has_n = true; }
        }
        int32_t v = resolve_index(vi, vs.size() / 3);
        int32_t t = (has_t && ti != 0) ? resolve_index(ti, vts.size() / 2) : -1;
        int32_t n = (has_n && ni != 0) ? resolve_index(ni, vns.size() / 3) : -1;
        // Bounds checks: malformed indices ('f 0 1 2', overruns) must fail
        // the load cleanly, not read out of bounds (the ctypes wrapper
        // raises IOError on nullptr, same as the Python parser's
        // IndexError).
        if (v < 0 || (size_t)v >= vs.size() / 3) { ok = false; return 0; }
        if (t >= 0 && (size_t)t >= vts.size() / 2) { ok = false; return 0; }
        if (n >= 0 && (size_t)n >= vns.size() / 3) { ok = false; return 0; }
        uint64_t key = ((uint64_t)(uint32_t)v << 42)
                       ^ ((uint64_t)(uint32_t)(t + 1) << 21)
                       ^ (uint64_t)(uint32_t)(n + 1);
        auto it = dedup.find(key);
        if (it != dedup.end()) return it->second;
        int32_t id = (int32_t)(mesh->positions.size() / 3);
        mesh->positions.insert(mesh->positions.end(),
                               {vs[3 * v], vs[3 * v + 1], vs[3 * v + 2]});
        if (t >= 0) {
            mesh->uvs.insert(mesh->uvs.end(), {vts[2 * t], vts[2 * t + 1]});
        } else {
            mesh->uvs.insert(mesh->uvs.end(), {0.f, 0.f});
        }
        if (n >= 0) {
            mesh->normals.insert(mesh->normals.end(),
                                 {vns[3 * n], vns[3 * n + 1], vns[3 * n + 2]});
        } else {
            mesh->normals.insert(mesh->normals.end(), {0.f, 0.f, 0.f});
        }
        dedup.emplace(key, id);
        return id;
    };

    while (fgets(line, sizeof line, f)) {
        char* p = line;
        while (*p == ' ' || *p == '\t') ++p;
        if (p[0] == 'v' && p[1] == ' ') {
            float x = 0, y = 0, z = 0;
            sscanf(p + 2, "%f %f %f", &x, &y, &z);
            vs.insert(vs.end(), {x, y, z});
        } else if (p[0] == 'v' && p[1] == 't') {
            float u = 0, v2 = 0;
            sscanf(p + 3, "%f %f", &u, &v2);
            vts.insert(vts.end(), {u, v2});
        } else if (p[0] == 'v' && p[1] == 'n') {
            float x = 0, y = 0, z = 0;
            sscanf(p + 3, "%f %f %f", &x, &y, &z);
            vns.insert(vns.end(), {x, y, z});
        } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
            std::vector<int32_t> ids;
            char* save = nullptr;
            for (char* tok = strtok_r(p + 2, " \t\r\n", &save); tok;
                 tok = strtok_r(nullptr, " \t\r\n", &save))
                ids.push_back(corner(tok));
            for (size_t k = 1; k + 1 < ids.size(); ++k) {
                mesh->indices.push_back(ids[0]);
                mesh->indices.push_back(ids[k]);
                mesh->indices.push_back(ids[k + 1]);
            }
        }
    }
    fclose(f);
    if (!ok) { delete mesh; return nullptr; }
    return mesh;
}

void sr_obj_counts(void* handle, int32_t* n_vertices, int32_t* n_indices) {
    auto* mesh = (ObjMesh*)handle;
    *n_vertices = (int32_t)(mesh->positions.size() / 3);
    *n_indices = (int32_t)mesh->indices.size();
}

void sr_obj_fill(void* handle, float* positions, float* normals, float* uvs,
                 int32_t* indices) {
    auto* mesh = (ObjMesh*)handle;
    memcpy(positions, mesh->positions.data(),
           mesh->positions.size() * sizeof(float));
    memcpy(normals, mesh->normals.data(),
           mesh->normals.size() * sizeof(float));
    memcpy(uvs, mesh->uvs.data(), mesh->uvs.size() * sizeof(float));
    memcpy(indices, mesh->indices.data(),
           mesh->indices.size() * sizeof(int32_t));
}

void sr_obj_free(void* handle) { delete (ObjMesh*)handle; }

}  // extern "C"
