// Golden-fixture probe: drives the REFERENCE library (read-only mount) to
// dump stage-by-stage outputs for parity testing of the JAX rebuild.
// Lives outside the repo; only its binary outputs (fixtures) are consumed.
#include <lora_phy/phy.hpp>
#include <lora_phy/ChirpGenerator.hpp>
#include <lora_phy/LoRaCodes.hpp>
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

using namespace lora_phy;

static void dump(const char* path, const void* data, size_t bytes) {
    FILE* f = fopen(path, "wb");
    fwrite(data, 1, bytes, f);
    fclose(f);
}

int main(int argc, char** argv) {
    // args: sf bw osr window payload_hex outdir
    unsigned sf = atoi(argv[1]);
    unsigned bw_hz = atoi(argv[2]);
    unsigned osr = atoi(argv[3]);
    int use_hann = atoi(argv[4]);
    std::string hex = argv[5];
    std::string outdir = argv[6];

    bandwidth bw = bw_hz == 250000 ? bandwidth::bw_250
                 : bw_hz == 500000 ? bandwidth::bw_500 : bandwidth::bw_125;

    std::vector<uint8_t> payload;
    for (size_t i = 0; i + 1 < hex.size(); i += 2)
        payload.push_back((uint8_t)strtoul(hex.substr(i, 2).c_str(), nullptr, 16));

    const size_t N = 1u << sf;
    const size_t step = N * osr;

    // encode
    std::vector<uint16_t> symbols(payload.size() * 2);
    size_t nsym = lora_encode(payload.data(), payload.size(), symbols.data(), sf);

    // modulate
    std::vector<std::complex<float>> iq((nsym + 2) * step);
    size_t nsamp = lora_modulate(symbols.data(), nsym, iq.data(), sf, osr, bw, 1.0f, 0x12);

    // base downchirp (osr-aware, as e2e does for osr=1)
    std::vector<std::complex<float>> down(step);
    float phase = 0.0f;
    genChirp(down.data(), (int)N, (int)osr, (int)step, 0.0f, true, 1.0f, phase,
             bw_hz / 125000.0f);

    // external dechirp
    std::vector<std::complex<float>> dech(nsamp);
    for (size_t s = 0; s < nsym + 2; ++s)
        for (size_t i = 0; i < step; ++i)
            dech[s * step + i] = iq[s * step + i] * down[i];

    // demodulate (working path)
    std::vector<uint16_t> demod(nsym + 2);
    std::vector<std::complex<float>> scratch(nsamp);
    lora_demod_workspace ws{};
    lora_demod_init(&ws, sf, use_hann ? window_type::window_hann : window_type::window_none,
                    scratch.data(), scratch.size());
    uint8_t sync = 0;
    size_t ndem = lora_demodulate(&ws, dech.data(), nsamp, demod.data(), osr, &sync);
    float cfo = ws.metrics.cfo, toff = ws.metrics.time_offset;
    lora_demod_free(&ws);

    // decode
    std::vector<uint8_t> decoded(ndem / 2);
    size_t nbytes = lora_decode(demod.data(), ndem, decoded.data());

    dump((outdir + "/symbols.u16").c_str(), symbols.data(), nsym * 2);
    dump((outdir + "/iq.c64").c_str(), iq.data(), nsamp * 8);
    dump((outdir + "/down.c64").c_str(), down.data(), step * 8);
    dump((outdir + "/dechirped.c64").c_str(), dech.data(), nsamp * 8);
    dump((outdir + "/demod.u16").c_str(), demod.data(), ndem * 2);
    dump((outdir + "/decoded.u8").c_str(), decoded.data(), nbytes);
    float meta[3] = {cfo, toff, (float)sync};
    dump((outdir + "/meta.f32").c_str(), meta, sizeof(meta));
    printf("sf=%u bw=%u osr=%u nsym=%zu ndem=%zu sync=0x%02x cfo=%g toff=%g\n",
           sf, bw_hz, osr, nsym, ndem, sync, cfo, toff);
    return 0;
}
