// PNG row unfiltering (ISO 15948, section 9): each scanline of the inflated
// stream is one filter-type byte and `rowbytes` filtered bytes; `bpp` is the
// byte distance to the corresponding byte of the pixel on the left. The
// Average and Paeth filters depend on the reconstructed byte to the left,
// so the rows are undone byte by byte here.
#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* in, uint8_t* out, int height, int rowbytes,
                            int bpp) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* f = in + (size_t)y * (rowbytes + 1);
        const int type = f[0];
        const uint8_t* s = f + 1;
        uint8_t* d = out + (size_t)y * rowbytes;
        const uint8_t* up = y ? d - rowbytes : nullptr;
        for (int x = 0; x < rowbytes; ++x) {
            const int a = x >= bpp ? d[x - bpp] : 0;
            const int b = up ? up[x] : 0;
            const int c = (up && x >= bpp) ? up[x - bpp] : 0;
            int p;
            switch (type) {
                case 0: p = 0; break;
                case 1: p = a; break;
                case 2: p = b; break;
                case 3: p = (a + b) >> 1; break;
                case 4: {
                    const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
                    p = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return y + 1;  // the 1-based row with an unknown filter
            }
            d[x] = (uint8_t)(s[x] + p);
        }
    }
    return 0;
}
