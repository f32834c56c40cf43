// Fast OBJ loader + triangle-mesh builder (native tier).
//
// Mirrors the reference's src/driver/obj.cpp / obj.h behavior and the
// Python twin rodent_tpu/io/obj.py (load_obj + compute_tri_mesh):
// slot-0 dummy entries, negative-index resolution, fan triangulation,
// per-object (v,t,n) dedup in first-seen order, the 4-ints-per-triangle
// (v0,v1,v2,material_id) stream, smooth-normal accumulation when the OBJ
// has no vn, and the degenerate-normal fixup (obj.cpp:412-511).
//
// The Python loader tops out around ~100K tris/s; this parser handles
// San-Miguel-class (5-10M tri) scenes in seconds.
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
    int32_t v, t, n;
    bool operator==(const Key& o) const {
        return v == o.v && t == o.t && n == o.n;
    }
};
struct KeyHash {
    size_t operator()(const Key& k) const {
        uint64_t h = (uint64_t)(uint32_t)k.v * 0x9E3779B97F4A7C15ull;
        h ^= (uint64_t)(uint32_t)k.t * 0xC2B2AE3D27D4EB4Full;
        h ^= (uint64_t)(uint32_t)k.n * 0x165667B19E3779F9ull;
        h ^= h >> 29;
        return (size_t)h;
    }
};

struct Face {
    uint32_t first, count;  // span into the corner stream
    int32_t material;
};
struct Group {
    std::vector<Face> faces;
};
struct Object {
    std::vector<Group> groups;
    std::vector<Key> corners;  // corner stream shared by this object's faces
};

struct ObjMesh {
    std::vector<float> vertices;      // (V, 3)
    std::vector<float> normals;      // (V, 3)
    std::vector<float> texcoords;    // (V, 2)
    std::vector<float> face_normals; // (T, 3)
    std::vector<int32_t> indices;    // (T*4,)
    std::string strings;             // materials then mtl libs, NUL-joined
    int64_t nmat = 0, nlibs = 0;
};

// --- tokenizer over the whole file buffer ---
struct Cursor {
    const char* p;
    const char* end;
};

inline void skip_ws(Cursor& c) {
    while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r'))
        ++c.p;
}

inline bool next_token(Cursor& c, const char** tok, size_t* len) {
    skip_ws(c);
    if (c.p >= c.end || *c.p == '\n') return false;
    const char* s = c.p;
    while (c.p < c.end && *c.p != ' ' && *c.p != '\t' && *c.p != '\r'
           && *c.p != '\n')
        ++c.p;
    *tok = s;
    *len = (size_t)(c.p - s);
    return true;
}

inline void skip_line(Cursor& c) {
    while (c.p < c.end && *c.p != '\n') ++c.p;
    if (c.p < c.end) ++c.p;
}

inline float parse_float(Cursor& c, float dflt) {
    skip_ws(c);
    if (c.p >= c.end || *c.p == '\n') return dflt;
    char* e = nullptr;
    double d = strtod(c.p, &e);
    if (e == c.p) {  // consume the junk token, mirror the 0.0 default
        const char* t; size_t l;
        next_token(c, &t, &l);
        return dflt;
    }
    c.p = e;
    return (float)d;
}

}  // namespace

extern "C" {

void* rt_obj_load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf((size_t)size + 1);
    if (size > 0 && fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
        fclose(f);
        return nullptr;
    }
    fclose(f);
    buf[(size_t)size] = '\n';

    // ---- parse (load_obj) ----
    std::vector<float> vx{0}, vy{0}, vz{0};           // slot-0 dummies
    std::vector<float> nx{0}, ny{0}, nz{0};
    std::vector<float> tu{0}, tv{0};
    std::vector<Object> objects(1);
    objects.back().groups.emplace_back();
    std::vector<std::string> materials{""};
    std::unordered_map<std::string, int32_t> mat_index{{"", 0}};
    std::vector<std::string> mtl_libs;
    int32_t cur_material = 0;

    Cursor c{buf.data(), buf.data() + size + 1};
    while (c.p < c.end) {
        skip_ws(c);
        if (c.p >= c.end) break;
        if (*c.p == '\n') { ++c.p; continue; }
        if (*c.p == '#') { skip_line(c); continue; }
        const char* tag = ""; size_t tl = 0;
        next_token(c, &tag, &tl);
        if (!tl) { skip_line(c); continue; }
        if (tl == 1 && tag[0] == 'v') {
            vx.push_back(parse_float(c, 0));
            vy.push_back(parse_float(c, 0));
            vz.push_back(parse_float(c, 0));
        } else if (tl == 2 && tag[0] == 'v' && tag[1] == 'n') {
            nx.push_back(parse_float(c, 0));
            ny.push_back(parse_float(c, 0));
            nz.push_back(parse_float(c, 0));
        } else if (tl == 2 && tag[0] == 'v' && tag[1] == 't') {
            tu.push_back(parse_float(c, 0));
            tv.push_back(parse_float(c, 0));
        } else if (tl == 1 && tag[0] == 'f') {
            Object& obj = objects.back();
            uint32_t first = (uint32_t)obj.corners.size();
            const char* tok; size_t len;
            while (next_token(c, &tok, &len)) {
                // token = v[/t[/n]] with empty components allowed
                int32_t comp[3] = {0, 0, 0};
                const char* s = tok;
                const char* e = tok + len;
                for (int k = 0; k < 3 && s <= e; ++k) {
                    const char* slash = (const char*)memchr(
                        s, '/', (size_t)(e - s));
                    const char* ce = slash ? slash : e;
                    if (ce > s) comp[k] = (int32_t)strtol(s, nullptr, 10);
                    if (!slash) break;
                    s = slash + 1;
                }
                if (comp[0] < 0) comp[0] += (int32_t)vx.size();
                if (comp[1] < 0) comp[1] += (int32_t)tu.size();
                if (comp[2] < 0) comp[2] += (int32_t)nx.size();
                obj.corners.push_back({comp[0], comp[1], comp[2]});
            }
            uint32_t count = (uint32_t)obj.corners.size() - first;
            if (count >= 3)
                obj.groups.back().faces.push_back(
                    {first, count, cur_material});
            else
                obj.corners.resize(first);
        } else if (tl == 1 && (tag[0] == 'g' || tag[0] == 's')) {
            objects.back().groups.emplace_back();
            skip_line(c);
            continue;
        } else if (tl == 1 && tag[0] == 'o') {
            objects.emplace_back();
            objects.back().groups.emplace_back();
            skip_line(c);
            continue;
        } else if (tl == 6 && memcmp(tag, "usemtl", 6) == 0) {
            const char* tok; size_t len;
            std::string name;
            if (next_token(c, &tok, &len)) name.assign(tok, len);
            auto it = mat_index.find(name);
            if (it == mat_index.end()) {
                it = mat_index.emplace(name,
                                       (int32_t)materials.size()).first;
                materials.push_back(name);
            }
            cur_material = it->second;
        } else if (tl == 6 && memcmp(tag, "mtllib", 6) == 0) {
            std::string lib;
            const char* tok; size_t len;
            while (next_token(c, &tok, &len)) {
                if (!lib.empty()) lib += ' ';
                lib.append(tok, len);
            }
            mtl_libs.push_back(lib);
        }
        skip_line(c);
    }

    // ---- compute_tri_mesh ----
    auto* mesh = new ObjMesh();
    const int32_t V = (int32_t)vx.size();
    const int32_t N = (int32_t)nx.size();
    const int32_t T = (int32_t)tu.size();
    int64_t vtx_offset = 0;
    for (Object& obj : objects) {
        std::unordered_map<Key, int32_t, KeyHash> mapping;
        std::vector<Key> order;
        std::vector<int32_t> tris;  // 4 per tri, local v slots
        bool has_normals = false, has_texcoords = false;
        for (Group& g : obj.groups) {
            for (Face& face : g.faces) {
                const Key* idx = obj.corners.data() + face.first;
                for (uint32_t i = 0; i < face.count; ++i) {
                    auto it = mapping.find(idx[i]);
                    if (it == mapping.end()) {
                        has_normals |= idx[i].n != 0;
                        has_texcoords |= idx[i].t != 0;
                        mapping.emplace(idx[i], (int32_t)order.size());
                        order.push_back(idx[i]);
                    }
                }
                int32_t s0 = mapping[idx[0]];
                int32_t prev = mapping[idx[1]];
                for (uint32_t i = 1; i + 1 < face.count; ++i) {
                    int32_t nxt = mapping[idx[i + 1]];
                    tris.push_back(s0);
                    tris.push_back(prev);
                    tris.push_back(nxt);
                    tris.push_back(face.material);
                    prev = nxt;
                }
            }
        }
        int64_t ntri = (int64_t)tris.size() / 4;
        if (!ntri) continue;

        int64_t nvert = (int64_t)order.size();
        size_t vbase = mesh->vertices.size();
        mesh->vertices.resize(vbase + (size_t)nvert * 3);
        mesh->texcoords.resize(mesh->texcoords.size() + (size_t)nvert * 2,
                               0.0f);
        mesh->normals.resize(mesh->normals.size() + (size_t)nvert * 3,
                             0.0f);
        float* verts = mesh->vertices.data() + vbase;
        float* texs = mesh->texcoords.data()
                      + (mesh->texcoords.size() - (size_t)nvert * 2);
        float* norms = mesh->normals.data()
                       + (mesh->normals.size() - (size_t)nvert * 3);
        for (int64_t i = 0; i < nvert; ++i) {
            int32_t v = order[(size_t)i].v;
            if (v < 0 || v >= V) v = 0;
            verts[i * 3 + 0] = vx[(size_t)v];
            verts[i * 3 + 1] = vy[(size_t)v];
            verts[i * 3 + 2] = vz[(size_t)v];
            if (has_texcoords) {
                int32_t t = order[(size_t)i].t;
                if (t < 0 || t >= T) t = 0;
                texs[i * 2 + 0] = tu[(size_t)t];
                texs[i * 2 + 1] = tv[(size_t)t];
            }
            if (has_normals) {
                int32_t n = order[(size_t)i].n;
                if (n < 0 || n >= N) n = 0;
                norms[i * 3 + 0] = nx[(size_t)n];
                norms[i * 3 + 1] = ny[(size_t)n];
                norms[i * 3 + 2] = nz[(size_t)n];
            }
        }

        size_t ibase = mesh->indices.size();
        mesh->indices.resize(ibase + (size_t)ntri * 4);
        size_t fbase = mesh->face_normals.size();
        mesh->face_normals.resize(fbase + (size_t)ntri * 3);
        for (int64_t tI = 0; tI < ntri; ++tI) {
            int32_t a = tris[(size_t)tI * 4 + 0];
            int32_t b = tris[(size_t)tI * 4 + 1];
            int32_t d = tris[(size_t)tI * 4 + 2];
            mesh->indices[ibase + (size_t)tI * 4 + 0] =
                (int32_t)(a + vtx_offset);
            mesh->indices[ibase + (size_t)tI * 4 + 1] =
                (int32_t)(b + vtx_offset);
            mesh->indices[ibase + (size_t)tI * 4 + 2] =
                (int32_t)(d + vtx_offset);
            mesh->indices[ibase + (size_t)tI * 4 + 3] =
                tris[(size_t)tI * 4 + 3];
            float e1x = verts[b * 3 + 0] - verts[a * 3 + 0];
            float e1y = verts[b * 3 + 1] - verts[a * 3 + 1];
            float e1z = verts[b * 3 + 2] - verts[a * 3 + 2];
            float e2x = verts[d * 3 + 0] - verts[a * 3 + 0];
            float e2y = verts[d * 3 + 1] - verts[a * 3 + 1];
            float e2z = verts[d * 3 + 2] - verts[a * 3 + 2];
            float fx = e1y * e2z - e1z * e2y;
            float fy = e1z * e2x - e1x * e2z;
            float fz = e1x * e2y - e1y * e2x;
            // division (not reciprocal-mul) to match the Python twin's
            // fn / max(|fn|, 1e-30) bit-for-bit
            float len = std::sqrt(fx * fx + fy * fy + fz * fz);
            float l = len > 1e-30f ? len : 1e-30f;
            fx /= l; fy /= l; fz /= l;
            mesh->face_normals[fbase + (size_t)tI * 3 + 0] = fx;
            mesh->face_normals[fbase + (size_t)tI * 3 + 1] = fy;
            mesh->face_normals[fbase + (size_t)tI * 3 + 2] = fz;
            if (!has_normals) {
                for (int k = 0; k < 3; ++k) {
                    int32_t s = tris[(size_t)tI * 4 + k];
                    norms[s * 3 + 0] += fx;
                    norms[s * 3 + 1] += fy;
                    norms[s * 3 + 2] += fz;
                }
            }
        }
        vtx_offset += nvert;
    }

    // degenerate-normal fixup (obj.cpp:495-508)
    int64_t total_v = (int64_t)mesh->normals.size() / 3;
    for (int64_t i = 0; i < total_v; ++i) {
        float* n = mesh->normals.data() + i * 3;
        float len2 = n[0] * n[0] + n[1] * n[1] + n[2] * n[2];
        if (!(len2 > 1.19209290e-7f) || !std::isfinite(len2)) {
            n[0] = 0.0f; n[1] = 1.0f; n[2] = 0.0f;
        } else {
            float l = std::sqrt(len2 > 1e-30f ? len2 : 1e-30f);
            n[0] /= l; n[1] /= l; n[2] /= l;
        }
    }

    mesh->nmat = (int64_t)materials.size();
    mesh->nlibs = (int64_t)mtl_libs.size();
    for (auto& m : materials) {
        mesh->strings += m;
        mesh->strings += '\0';
    }
    for (auto& l : mtl_libs) {
        mesh->strings += l;
        mesh->strings += '\0';
    }
    return mesh;
}

void rt_obj_counts(void* h, long long* out) {
    auto* m = (ObjMesh*)h;
    out[0] = (long long)(m->vertices.size() / 3);
    out[1] = (long long)(m->indices.size() / 4);
    out[2] = (long long)m->nmat;
    out[3] = (long long)m->nlibs;
    out[4] = (long long)m->strings.size();
}

void rt_obj_copy(void* h, float* v, float* n, float* t, float* fn,
                 int32_t* idx, char* str) {
    auto* m = (ObjMesh*)h;
    memcpy(v, m->vertices.data(), m->vertices.size() * 4);
    memcpy(n, m->normals.data(), m->normals.size() * 4);
    memcpy(t, m->texcoords.data(), m->texcoords.size() * 4);
    memcpy(fn, m->face_normals.data(), m->face_normals.size() * 4);
    memcpy(idx, m->indices.data(), m->indices.size() * 4);
    memcpy(str, m->strings.data(), m->strings.size());
}

void rt_obj_free(void* h) { delete (ObjMesh*)h; }

}  // extern "C"
