// Dumps exhaustive truth tables of the REFERENCE coding primitives for
// bit-exactness testing of the JAX rebuild.
#include <lora_phy/LoRaCodes.hpp>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>
#include <string>

static void dump(const std::string& path, const void* data, size_t bytes) {
    FILE* f = fopen(path.c_str(), "wb");
    fwrite(data, 1, bytes, f);
    fclose(f);
}

int main(int argc, char** argv) {
    std::string out = argv[1];

    uint8_t h84e[16]; for (int i = 0; i < 16; i++) h84e[i] = encodeHamming84sx(i);
    dump(out + "/h84_enc.u8", h84e, 16);
    uint8_t h84d[256], h84err[256], h84bad[256];
    for (int i = 0; i < 256; i++) { bool e=false,b=false; h84d[i]=decodeHamming84sx(i,e,b); h84err[i]=e; h84bad[i]=b; }
    dump(out + "/h84_dec.u8", h84d, 256); dump(out + "/h84_err.u8", h84err, 256); dump(out + "/h84_bad.u8", h84bad, 256);

    uint8_t h74e[16]; for (int i = 0; i < 16; i++) h74e[i] = encodeHamming74sx(i);
    dump(out + "/h74_enc.u8", h74e, 16);
    uint8_t h74d[128], h74err[128];
    for (int i = 0; i < 128; i++) { bool e=false; h74d[i]=decodeHamming74sx(i,e); h74err[i]=e; }
    dump(out + "/h74_dec.u8", h74d, 128); dump(out + "/h74_err.u8", h74err, 128);

    uint8_t p54e[16]; for (int i=0;i<16;i++) p54e[i]=encodeParity54(i);
    dump(out + "/p54_enc.u8", p54e, 16);
    uint8_t p54c[32], p54err[32];
    for (int i=0;i<32;i++){ bool e=false; p54c[i]=checkParity54(i,e); p54err[i]=e; }
    dump(out + "/p54_chk.u8", p54c, 32); dump(out + "/p54_err.u8", p54err, 32);
    uint8_t p64e[16]; for (int i=0;i<16;i++) p64e[i]=encodeParity64(i);
    dump(out + "/p64_enc.u8", p64e, 16);
    uint8_t p64c[64], p64err[64];
    for (int i=0;i<64;i++){ bool e=false; p64c[i]=checkParity64(i,e); p64err[i]=e; }
    dump(out + "/p64_chk.u8", p64c, 64); dump(out + "/p64_err.u8", p64err, 64);

    // gray over 16 bits
    std::vector<uint16_t> g(65536), gi(65536);
    for (int i = 0; i < 65536; i++) { g[i]=binaryToGray16(i); gi[i]=grayToBinary16(i); }
    dump(out + "/gray_enc.u16", g.data(), 131072); dump(out + "/gray_dec.u16", gi.data(), 131072);

    // whitening keystreams: XOR against zero buffers
    { std::vector<uint8_t> buf(600, 0); SX1232RadioComputeWhitening(buf.data(), buf.size());
      dump(out + "/wh_sx1232.u8", buf.data(), buf.size()); }
    for (int rdd = 0; rdd <= 4; rdd++) {
        for (int ofs : {0, 1, 7, 100}) {
            std::vector<uint8_t> buf(600, 0);
            Sx1272ComputeWhitening(buf.data(), buf.size(), ofs, rdd);
            char name[64]; snprintf(name, 64, "/wh_seq_r%d_o%d.u8", rdd, ofs);
            dump(out + name, buf.data(), buf.size());
            std::vector<uint8_t> buf2(600, 0);
            Sx1272ComputeWhiteningLfsr(buf2.data(), buf2.size(), ofs, rdd);
            snprintf(name, 64, "/wh_lfsr_r%d_o%d.u8", rdd, ofs);
            dump(out + name, buf2.data(), buf2.size());
        }
    }

    // CRC16 over random payloads of many lengths + headerChecksum + checksum8
    std::mt19937 rng(1234);
    std::vector<uint8_t> blob(255); for (auto& b : blob) b = rng() & 0xFF;
    dump(out + "/crc_input.u8", blob.data(), blob.size());
    std::vector<uint16_t> crcs(256);
    for (int len = 0; len <= 255; len++) crcs[len] = sx1272DataChecksum(blob.data(), len);
    dump(out + "/crc_by_len.u16", crcs.data(), 512);
    std::vector<uint8_t> hc(256);
    for (int i = 0; i < 256; i++) { uint8_t h[2] = {(uint8_t)i, (uint8_t)(i*37+11)}; hc[i] = headerChecksum(h); }
    dump(out + "/header_chk.u8", hc.data(), 256);
    std::vector<uint8_t> c8(256);
    for (int len = 0; len < 256; len++) c8[len] = checksum8(blob.data(), len);
    dump(out + "/checksum8.u8", c8.data(), 256);

    // interleavers: for each (PPM, RDD), random codewords -> symbols -> back
    for (int ppm : {7, 8, 10, 12}) {
        for (int rdd = 0; rdd <= 4; rdd++) {
            int blocks = 3, ncw = blocks * ppm, nsym = blocks * (4 + rdd);
            std::vector<uint8_t> cw(ncw);
            for (auto& c : cw) c = rng() & (0xFF >> (4 - rdd));
            std::vector<uint16_t> sym(nsym, 0);
            diagonalInterleaveSx(cw.data(), ncw, sym.data(), ppm, rdd);
            std::vector<uint8_t> cw2(ncw, 0);
            diagonalDeterleaveSx(sym.data(), nsym, cw2.data(), ppm, rdd);
            std::vector<uint8_t> cw3(ncw, 0);
            diagonalDeterleaveSx2(sym.data(), nsym, cw3.data(), ppm, rdd);
            char name[64];
            snprintf(name, 64, "/il_cw_p%d_r%d.u8", ppm, rdd); dump(out + name, cw.data(), ncw);
            snprintf(name, 64, "/il_sym_p%d_r%d.u16", ppm, rdd); dump(out + name, sym.data(), nsym*2);
            snprintf(name, 64, "/il_cwback_p%d_r%d.u8", ppm, rdd); dump(out + name, cw2.data(), ncw);
            snprintf(name, 64, "/il_cwback2_p%d_r%d.u8", ppm, rdd); dump(out + name, cw3.data(), ncw);
        }
    }
    printf("codes dumped to %s\n", out.c_str());
    return 0;
}
