// Native FLAC decoder (host audio IO).
//
// Role: the reference reads LibriSpeech .flac via soundfile/libsndfile
// (essentials.py:301-319; the corpus ships FLAC, librispeech_asr.py:104);
// the PyTorch port decodes FLAC itself (its copy of
// asr_model_tpu/native/flac.cpp) and needs neither.  Implements the full fixed-blocking decode path of RFC 9639:
// STREAMINFO parsing, frame sync + header (UTF-8 coded numbers, CRC-8),
// CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, wasted bits,
// partitioned Rice residuals (4- and 5-bit parameters + escape codes),
// inter-channel decorrelation (left/side, right/side, mid/side), CRC-16
// frame verification.
//
// C ABI (ctypes):
//   flac_info(data, len, &sample_rate, &channels, &bps, &total_samples)
//   flac_decode(data, len, out_i32 /*interleaved*/, cap) -> frames or <0
//
// Error codes: -1 bad magic / no STREAMINFO, -2 truncated stream,
// -3 malformed frame, -4 CRC mismatch, -5 output buffer too small.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t len;
    size_t byte_pos = 0;
    int bit_pos = 0;  // bits consumed of current byte, MSB first
    bool ok = true;

    bool eof() const { return byte_pos >= len; }

    uint32_t read_bit() {
        if (byte_pos >= len) { ok = false; return 0; }
        uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
        if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
        return b;
    }

    uint64_t read_bits(int n) {
        uint64_t v = 0;
        for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
        return v;
    }

    int64_t read_signed(int n) {
        if (n == 0) return 0;
        uint64_t v = read_bits(n);
        uint64_t sign = 1ull << (n - 1);
        return (v & sign) ? static_cast<int64_t>(v) - (1ll << n)
                          : static_cast<int64_t>(v);
    }

    // FLAC unary: q zero-bits followed by a one-bit -> q
    uint32_t read_unary() {
        uint32_t q = 0;
        while (ok) {
            if (read_bit()) return q;
            ++q;
            if (q > 1u << 24) { ok = false; return 0; }  // corrupt guard
        }
        return 0;
    }

    void align() { if (bit_pos) { bit_pos = 0; ++byte_pos; } }
};

uint8_t crc8(const uint8_t* d, size_t n) {
    uint8_t c = 0;
    for (size_t i = 0; i < n; ++i) {
        c ^= d[i];
        for (int k = 0; k < 8; ++k)
            c = (c & 0x80) ? static_cast<uint8_t>((c << 1) ^ 0x07)
                           : static_cast<uint8_t>(c << 1);
    }
    return c;
}

uint16_t crc16(const uint8_t* d, size_t n) {
    uint16_t c = 0;
    for (size_t i = 0; i < n; ++i) {
        c ^= static_cast<uint16_t>(d[i]) << 8;
        for (int k = 0; k < 8; ++k)
            c = (c & 0x8000) ? static_cast<uint16_t>((c << 1) ^ 0x8005)
                             : static_cast<uint16_t>(c << 1);
    }
    return c;
}

struct StreamInfo {
    uint32_t sample_rate = 0;
    int channels = 0;
    int bps = 0;
    uint64_t total_samples = 0;
    size_t frames_offset = 0;  // byte offset of the first audio frame
};

bool parse_streaminfo(const uint8_t* data, size_t len, StreamInfo* si) {
    if (len < 4 + 4 + 34 || std::memcmp(data, "fLaC", 4) != 0) return false;
    size_t pos = 4;
    bool last = false, seen = false;
    while (!last) {
        if (pos + 4 > len) return false;
        last = (data[pos] & 0x80) != 0;
        int type = data[pos] & 0x7F;
        uint32_t blen = (static_cast<uint32_t>(data[pos + 1]) << 16)
                      | (static_cast<uint32_t>(data[pos + 2]) << 8)
                      | data[pos + 3];
        pos += 4;
        if (pos + blen > len) return false;
        if (type == 0 && blen >= 34) {
            const uint8_t* b = data + pos;
            si->sample_rate = (static_cast<uint32_t>(b[10]) << 12)
                            | (static_cast<uint32_t>(b[11]) << 4)
                            | (b[12] >> 4);
            si->channels = ((b[12] >> 1) & 0x7) + 1;
            si->bps = ((b[12] & 1) << 4 | (b[13] >> 4)) + 1;
            si->total_samples = (static_cast<uint64_t>(b[13] & 0x0F) << 32)
                              | (static_cast<uint64_t>(b[14]) << 24)
                              | (static_cast<uint64_t>(b[15]) << 16)
                              | (static_cast<uint64_t>(b[16]) << 8)
                              | b[17];
            seen = true;
        }
        pos += blen;
    }
    si->frames_offset = pos;
    return seen;
}

// returns samples decoded into ch, or -1
long long decode_subframe(BitReader* br, uint32_t blocksize, int bps,
                          std::vector<int64_t>* ch) {
    if (br->read_bit() != 0) return -1;  // zero pad bit
    int type = static_cast<int>(br->read_bits(6));
    int wasted = 0;
    if (br->read_bit()) wasted = static_cast<int>(br->read_unary()) + 1;
    bps -= wasted;
    if (bps <= 0 || bps > 33) return -1;

    ch->assign(blocksize, 0);
    int order = 0;
    bool fixed = false, lpc = false;
    if (type == 0) {  // CONSTANT
        int64_t v = br->read_signed(bps);
        for (uint32_t i = 0; i < blocksize; ++i) (*ch)[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (uint32_t i = 0; i < blocksize; ++i)
            (*ch)[i] = br->read_signed(bps);
    } else if (type >= 8 && type <= 12) {
        fixed = true; order = type - 8;
    } else if (type >= 32) {
        lpc = true; order = type - 31;
    } else {
        return -1;  // reserved
    }

    if (fixed || lpc) {
        if (static_cast<uint32_t>(order) > blocksize) return -1;
        for (int i = 0; i < order; ++i) (*ch)[i] = br->read_signed(bps);

        int precision = 0, shift = 0;
        std::vector<int64_t> coef;
        if (lpc) {
            precision = static_cast<int>(br->read_bits(4)) + 1;
            if (precision == 16 /*1111+1: invalid*/) return -1;
            shift = static_cast<int>(br->read_signed(5));
            if (shift < 0) return -1;
            coef.resize(order);
            for (int i = 0; i < order; ++i)
                coef[i] = br->read_signed(precision);
        }

        // partitioned Rice residual
        int method = static_cast<int>(br->read_bits(2));
        if (method > 1) return -1;
        int plen = method == 0 ? 4 : 5;
        uint32_t esc = method == 0 ? 0xF : 0x1F;
        int porder = static_cast<int>(br->read_bits(4));
        uint32_t nparts = 1u << porder;
        if ((blocksize >> porder) << porder != blocksize) return -1;
        uint32_t idx = order;
        for (uint32_t p = 0; p < nparts; ++p) {
            uint32_t count = blocksize >> porder;
            if (p == 0) {
                if (count < static_cast<uint32_t>(order)) return -1;
                count -= order;
            }
            uint32_t param = static_cast<uint32_t>(br->read_bits(plen));
            if (param == esc) {
                int raw = static_cast<int>(br->read_bits(5));
                for (uint32_t i = 0; i < count; ++i)
                    (*ch)[idx++] = raw ? br->read_signed(raw) : 0;
            } else {
                for (uint32_t i = 0; i < count; ++i) {
                    uint64_t q = br->read_unary();
                    uint64_t uval = (q << param) | br->read_bits(
                        static_cast<int>(param));
                    (*ch)[idx++] = static_cast<int64_t>(uval >> 1)
                                 ^ -static_cast<int64_t>(uval & 1);
                }
            }
            if (!br->ok) return -1;
        }

        // prediction
        if (fixed) {
            int64_t* x = ch->data();
            switch (order) {
              case 0: break;
              case 1:
                for (uint32_t i = 1; i < blocksize; ++i) x[i] += x[i - 1];
                break;
              case 2:
                for (uint32_t i = 2; i < blocksize; ++i)
                    x[i] += 2 * x[i - 1] - x[i - 2];
                break;
              case 3:
                for (uint32_t i = 3; i < blocksize; ++i)
                    x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
                break;
              case 4:
                for (uint32_t i = 4; i < blocksize; ++i)
                    x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3]
                          - x[i - 4];
                break;
            }
        } else {
            int64_t* x = ch->data();
            for (uint32_t i = order; i < blocksize; ++i) {
                int64_t acc = 0;
                for (int j = 0; j < order; ++j)
                    acc += coef[j] * x[i - 1 - j];
                x[i] += acc >> shift;
            }
        }
    }

    if (wasted)
        for (uint32_t i = 0; i < blocksize; ++i) (*ch)[i] <<= wasted;
    return br->ok ? static_cast<long long>(blocksize) : -1;
}

}  // namespace

extern "C" {

int flac_info(const uint8_t* data, long long len, int* sample_rate,
              int* channels, int* bps, long long* total_samples) {
    StreamInfo si;
    if (!parse_streaminfo(data, static_cast<size_t>(len), &si)) return -1;
    *sample_rate = static_cast<int>(si.sample_rate);
    *channels = si.channels;
    *bps = si.bps;
    *total_samples = static_cast<long long>(si.total_samples);
    return 0;
}

long long flac_decode(const uint8_t* data, long long len_, int32_t* out,
                      long long cap) {
    size_t len = static_cast<size_t>(len_);
    StreamInfo si;
    if (!parse_streaminfo(data, len, &si)) return -1;

    BitReader br{data, len};
    br.byte_pos = si.frames_offset;

    long long written = 0;  // samples per channel
    std::vector<std::vector<int64_t>> chans(8);

    while (br.byte_pos < len) {
        size_t frame_start = br.byte_pos;
        // sync 11111111 111110xx
        if (data[frame_start] != 0xFF
            || (data[frame_start + 1] & 0xFC) != 0xF8) {
            // trailing garbage / padding: stop at first non-sync
            break;
        }
        br.bit_pos = 0;
        br.read_bits(14);                       // sync
        br.read_bit();                          // reserved
        br.read_bit();                          // blocking strategy
        uint32_t bs_code = static_cast<uint32_t>(br.read_bits(4));
        uint32_t sr_code = static_cast<uint32_t>(br.read_bits(4));
        uint32_t ch_asgn = static_cast<uint32_t>(br.read_bits(4));
        uint32_t ss_code = static_cast<uint32_t>(br.read_bits(3));
        br.read_bit();                          // reserved

        // UTF-8 coded frame/sample number (up to 7 bytes)
        uint32_t lead = static_cast<uint32_t>(br.read_bits(8));
        int extra = 0;
        if ((lead & 0x80) == 0) extra = 0;
        else if ((lead & 0xE0) == 0xC0) extra = 1;
        else if ((lead & 0xF0) == 0xE0) extra = 2;
        else if ((lead & 0xF8) == 0xF0) extra = 3;
        else if ((lead & 0xFC) == 0xF8) extra = 4;
        else if ((lead & 0xFE) == 0xFC) extra = 5;
        else if (lead == 0xFE) extra = 6;
        else return -3;
        for (int i = 0; i < extra; ++i) {
            if ((br.read_bits(8) & 0xC0) != 0x80) return -3;
        }

        uint32_t blocksize;
        switch (bs_code) {
          case 0: return -3;
          case 1: blocksize = 192; break;
          case 6: blocksize = static_cast<uint32_t>(br.read_bits(8)) + 1;
                  break;
          case 7: blocksize = static_cast<uint32_t>(br.read_bits(16)) + 1;
                  break;
          default:
            blocksize = bs_code <= 5 ? 576u << (bs_code - 2)
                                     : 256u << (bs_code - 8);
        }
        if (sr_code == 12) br.read_bits(8);
        else if (sr_code == 13 || sr_code == 14) br.read_bits(16);
        else if (sr_code == 15) return -3;

        int bps = si.bps;
        switch (ss_code) {
          case 0: break;                        // from STREAMINFO
          case 1: bps = 8; break;
          case 2: bps = 12; break;
          case 4: bps = 16; break;
          case 5: bps = 20; break;
          case 6: bps = 24; break;
          case 7: bps = 32; break;
          default: return -3;
        }

        // header CRC-8 covers everything since the sync code
        br.align();
        size_t hdr_len = br.byte_pos - frame_start;
        uint8_t want8 = static_cast<uint8_t>(br.read_bits(8));
        if (crc8(data + frame_start, hdr_len) != want8) return -4;

        int nch;
        if (ch_asgn < 8) nch = static_cast<int>(ch_asgn) + 1;
        else if (ch_asgn <= 10) nch = 2;
        else return -3;

        for (int c = 0; c < nch; ++c) {
            int ch_bps = bps;
            // the side channel carries one extra bit
            if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0)
                || (ch_asgn == 10 && c == 1))
                ch_bps += 1;
            if (decode_subframe(&br, blocksize, ch_bps, &chans[c]) < 0)
                return -3;
        }
        br.align();
        size_t body_len = br.byte_pos - frame_start;
        uint16_t want16 = static_cast<uint16_t>(br.read_bits(16));
        if (!br.ok) return -2;
        if (crc16(data + frame_start, body_len) != want16) return -4;

        // inter-channel decorrelation
        if (ch_asgn == 8) {         // left/side
            for (uint32_t i = 0; i < blocksize; ++i)
                chans[1][i] = chans[0][i] - chans[1][i];
        } else if (ch_asgn == 9) {  // right/side: ch0=side, ch1=right
            for (uint32_t i = 0; i < blocksize; ++i)
                chans[0][i] = chans[1][i] + chans[0][i];
        } else if (ch_asgn == 10) { // mid/side
            for (uint32_t i = 0; i < blocksize; ++i) {
                int64_t side = chans[1][i];
                int64_t mid = (chans[0][i] << 1) | (side & 1);
                chans[0][i] = (mid + side) >> 1;
                chans[1][i] = (mid - side) >> 1;
            }
        }

        if ((written + blocksize) * nch > cap) return -5;
        for (uint32_t i = 0; i < blocksize; ++i)
            for (int c = 0; c < nch; ++c)
                out[(written + i) * nch + c] =
                    static_cast<int32_t>(chans[c][i]);
        written += blocksize;
        if (si.total_samples
            && written >= static_cast<long long>(si.total_samples))
            break;
    }
    return written;
}

}  // extern "C"
