"""WebP's lossy bitstream: a VP8 key frame, decoded as libwebp decodes it
(the decoder cv2.imread calls), written from RFC 6386 without libwebp.

``parse_header`` reads the frame header with the boolean decoder:
segmentation (quantizer and filter levels, absolute or delta, the segment
map's probabilities), the loop filter (simple or normal, level,
sharpness, deltas by reference frame and mode), 1, 2, 4 or 8 token
partitions, the quantizer indices, the coefficient-probability updates
and the skip probability.  ``decode_macroblocks_py`` then decodes every
macroblock: its modes from the first partition (16x16, 4x4 with the
contexts of its neighbours, chroma), its tokens from its row's partition,
intra prediction with the frame-edge rules (127 above, 129 to the left),
the inverse WHT and DCT, and the loop filter over the whole frame in
macroblock order; ``decode_yuv`` crops the planes to the picture.
``yuv_to_rgb`` is libwebp's default conversion: the "fancy" upsampler of
the chroma planes and the 14-bit fixed-point YUV->RGB.

``decode_macroblocks_py`` is the spec of ``decode_macroblocks_native``
(``csrc/webp_host.cc``), which the reader runs; the tests hold the two
equal.  Tables: RFC 6386 sections 9-14.
"""

import struct

import numpy as np

from .vp8l import UnsupportedWebP

# ---------------------------------------------------------------- tables

# DC and AC dequantization factors by quantizer index (RFC 6386 14.1)
DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157)
AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
# the probability band of each coefficient position (the 17th: past the end)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
# extra-bit probabilities of the DCT_CAT3-6 tokens
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))

# intra modes: 16x16 and chroma (RFC 6386 order), 4x4 sub-block modes
DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED = range(5)
(B_DC_PRED, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_LD_PRED, B_RD_PRED, B_VR_PRED, B_VL_PRED,
 B_HD_PRED, B_HU_PRED) = range(10)
# a 16x16 mode as the sub-block mode its neighbours see
IMPLIED_BMODE = {DC_PRED: B_DC_PRED, V_PRED: B_VE_PRED, H_PRED: B_HE_PRED, TM_PRED: B_TM_PRED}
KF_YMODE_TREE = (-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED, -H_PRED, -TM_PRED)
KF_YMODE_PROB = (145, 156, 163, 128)
UV_MODE_TREE = (-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED)
KF_UV_MODE_PROB = (142, 114, 183)
BMODE_TREE = (-B_DC_PRED, 2, -B_TM_PRED, 4, -B_VE_PRED, 6, 8, 12, -B_HE_PRED, 10,
              -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 14, -B_VL_PRED, 16, -B_HD_PRED, -B_HU_PRED)
SEGMENT_TREE = (2, 4, -0, -1, -2, -3)
TRUNCATED = "a truncated VP8 partition"

# kf_bmode_probs[above][left]: the 4x4 mode probabilities (RFC 6386 11.5)
KF_BMODE_PROBS = (
    ((231, 120, 48, 89, 115, 113, 120, 152, 112), (152, 179, 64, 126, 170, 118, 46, 70, 95),
     (175, 69, 143, 80, 85, 82, 72, 155, 103), (56, 58, 10, 171, 218, 189, 17, 13, 152),
     (144, 71, 10, 38, 171, 213, 144, 34, 26), (114, 26, 17, 163, 44, 195, 21, 10, 173),
     (121, 24, 80, 195, 26, 62, 44, 64, 85), (170, 46, 55, 19, 136, 160, 33, 206, 71),
     (63, 20, 8, 114, 114, 208, 12, 9, 226), (81, 40, 11, 96, 182, 84, 29, 16, 36)),
    ((134, 183, 89, 137, 98, 101, 106, 165, 148), (72, 187, 100, 130, 157, 111, 32, 75, 80),
     (66, 102, 167, 99, 74, 62, 40, 234, 128), (41, 53, 9, 178, 241, 141, 26, 8, 107),
     (104, 79, 12, 27, 217, 255, 87, 17, 7), (74, 43, 26, 146, 73, 166, 49, 23, 157),
     (65, 38, 105, 160, 51, 52, 31, 115, 128), (87, 68, 71, 44, 114, 51, 15, 186, 23),
     (47, 41, 14, 110, 182, 183, 21, 17, 194), (66, 45, 25, 102, 197, 189, 23, 18, 22)),
    ((88, 88, 147, 150, 42, 46, 45, 196, 205), (43, 97, 183, 117, 85, 38, 35, 179, 61),
     (39, 53, 200, 87, 26, 21, 43, 232, 171), (56, 34, 51, 104, 114, 102, 29, 93, 77),
     (107, 54, 32, 26, 51, 1, 81, 43, 31), (39, 28, 85, 171, 58, 165, 90, 98, 64),
     (34, 22, 116, 206, 23, 34, 43, 166, 73), (68, 25, 106, 22, 64, 171, 36, 225, 114),
     (34, 19, 21, 102, 132, 188, 16, 76, 124), (62, 18, 78, 95, 85, 57, 50, 48, 51)),
    ((193, 101, 35, 159, 215, 111, 89, 46, 111), (60, 148, 31, 172, 219, 228, 21, 18, 111),
     (112, 113, 77, 85, 179, 255, 38, 120, 114), (40, 42, 1, 196, 245, 209, 10, 25, 109),
     (100, 80, 8, 43, 154, 1, 51, 26, 71), (88, 43, 29, 140, 166, 213, 37, 43, 154),
     (61, 63, 30, 155, 67, 45, 68, 1, 209), (142, 78, 78, 16, 255, 128, 34, 197, 171),
     (41, 40, 5, 102, 211, 183, 4, 1, 221), (51, 50, 17, 168, 209, 192, 23, 25, 82)),
    ((125, 98, 42, 88, 104, 85, 117, 175, 82), (95, 84, 53, 89, 128, 100, 113, 101, 45),
     (75, 79, 123, 47, 51, 128, 81, 171, 1), (57, 17, 5, 71, 102, 57, 53, 41, 49),
     (115, 21, 2, 10, 102, 255, 166, 23, 6), (38, 33, 13, 121, 57, 73, 26, 1, 85),
     (41, 10, 67, 138, 77, 110, 90, 47, 114), (101, 29, 16, 10, 85, 128, 101, 196, 26),
     (57, 18, 10, 102, 102, 213, 34, 20, 43), (117, 20, 15, 36, 163, 128, 68, 1, 26)),
    ((138, 31, 36, 171, 27, 166, 38, 44, 229), (67, 87, 58, 169, 82, 115, 26, 59, 179),
     (63, 59, 90, 180, 59, 166, 93, 73, 154), (40, 40, 21, 116, 143, 209, 34, 39, 175),
     (57, 46, 22, 24, 128, 1, 54, 17, 37), (47, 15, 16, 183, 34, 223, 49, 45, 183),
     (46, 17, 33, 183, 6, 98, 15, 32, 183), (65, 32, 73, 115, 28, 128, 23, 128, 205),
     (40, 3, 9, 115, 51, 192, 18, 6, 223), (87, 37, 9, 115, 59, 77, 64, 21, 47)),
    ((104, 55, 44, 218, 9, 54, 53, 130, 226), (64, 90, 70, 205, 40, 41, 23, 26, 57),
     (54, 57, 112, 184, 5, 41, 38, 166, 213), (30, 34, 26, 133, 152, 116, 10, 32, 134),
     (75, 32, 12, 51, 192, 255, 160, 43, 51), (39, 19, 53, 221, 26, 114, 32, 73, 255),
     (31, 9, 65, 234, 2, 15, 1, 118, 73), (88, 31, 35, 67, 102, 85, 55, 186, 85),
     (56, 21, 23, 111, 59, 205, 45, 37, 192), (55, 38, 70, 124, 73, 102, 1, 34, 98)),
    ((102, 61, 71, 37, 34, 53, 31, 243, 192), (69, 60, 71, 38, 73, 119, 28, 222, 37),
     (68, 45, 128, 34, 1, 47, 11, 245, 171), (62, 17, 19, 70, 146, 85, 55, 62, 70),
     (75, 15, 9, 9, 64, 255, 184, 119, 16), (37, 43, 37, 154, 100, 163, 85, 160, 1),
     (63, 9, 92, 136, 28, 64, 32, 201, 85), (86, 6, 28, 5, 64, 255, 25, 248, 1),
     (56, 8, 17, 132, 137, 255, 55, 116, 128), (58, 15, 20, 82, 135, 57, 26, 121, 40)),
    ((164, 50, 31, 137, 154, 133, 25, 35, 218), (51, 103, 44, 131, 131, 123, 31, 6, 158),
     (86, 40, 64, 135, 148, 224, 45, 183, 128), (22, 26, 17, 131, 240, 154, 14, 1, 209),
     (83, 12, 13, 54, 192, 255, 68, 47, 28), (45, 16, 21, 91, 64, 222, 7, 1, 197),
     (56, 21, 39, 155, 60, 138, 23, 102, 213), (85, 26, 85, 85, 128, 128, 32, 146, 171),
     (18, 11, 7, 63, 144, 171, 4, 4, 246), (35, 27, 10, 146, 174, 171, 12, 26, 128)),
    ((190, 80, 35, 99, 180, 80, 126, 54, 45), (85, 126, 47, 87, 176, 51, 41, 20, 32),
     (101, 75, 128, 139, 118, 146, 116, 128, 85), (56, 41, 15, 176, 236, 85, 37, 9, 62),
     (146, 36, 19, 30, 171, 255, 97, 27, 20), (71, 30, 17, 119, 118, 255, 17, 18, 138),
     (101, 38, 60, 138, 55, 70, 43, 26, 142), (138, 45, 61, 62, 219, 1, 81, 188, 64),
     (32, 41, 20, 117, 151, 142, 20, 21, 163), (112, 19, 12, 61, 195, 128, 48, 4, 24)))


def _rows(text):
    """A table written as rows of 11 numbers -> (4, 8, 3, 11) uint8."""
    return np.array([int(v) for v in text.split()], np.uint8).reshape(4, 8, 3, 11)


# default_coeff_probs (RFC 6386 13.5): [block type][band][context][node]
DEFAULT_COEF_PROBS = _rows("""
128 128 128 128 128 128 128 128 128 128 128  128 128 128 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128
253 136 254 255 228 219 128 128 128 128 128  189 129 242 255 227 213 255 219 128 128 128
106 126 227 252 214 209 255 255 128 128 128
1 98 248 255 236 226 255 255 128 128 128  181 133 238 254 221 234 255 154 128 128 128
78 134 202 247 198 180 255 219 128 128 128
1 185 249 255 243 255 128 128 128 128 128  184 150 247 255 236 224 128 128 128 128 128
77 110 216 255 236 230 128 128 128 128 128
1 101 251 255 241 255 128 128 128 128 128  170 139 241 252 236 209 255 255 128 128 128
37 116 196 243 228 255 255 255 128 128 128
1 204 254 255 245 255 128 128 128 128 128  207 160 250 255 238 128 128 128 128 128 128
102 103 231 255 211 171 128 128 128 128 128
1 152 252 255 240 255 128 128 128 128 128  177 135 243 255 234 225 128 128 128 128 128
80 129 211 255 194 224 128 128 128 128 128
1 1 255 128 128 128 128 128 128 128 128  246 1 255 128 128 128 128 128 128 128 128
255 128 128 128 128 128 128 128 128 128 128

198 35 237 223 193 187 162 160 145 155 62  131 45 198 221 172 176 220 157 252 221 1
68 47 146 208 149 167 221 162 255 223 128
1 149 241 255 221 224 255 255 128 128 128  184 141 234 253 222 220 255 199 128 128 128
81 99 181 242 176 190 249 202 255 255 128
1 129 232 253 214 197 242 196 255 255 128  99 121 210 250 201 198 255 202 128 128 128
23 91 163 242 170 187 247 210 255 255 128
1 200 246 255 234 255 128 128 128 128 128  109 178 241 255 231 245 255 255 128 128 128
44 130 201 253 205 192 255 255 128 128 128
1 132 239 251 219 209 255 165 128 128 128  94 136 225 251 218 190 255 255 128 128 128
22 100 174 245 186 161 255 199 128 128 128
1 182 249 255 232 235 128 128 128 128 128  124 143 241 255 227 234 128 128 128 128 128
35 77 181 251 193 211 255 205 128 128 128
1 157 247 255 236 231 255 255 128 128 128  121 141 235 255 225 227 255 255 128 128 128
45 99 188 251 195 217 255 224 128 128 128
1 1 251 255 213 255 128 128 128 128 128  203 1 248 255 255 128 128 128 128 128 128
137 1 177 255 224 255 128 128 128 128 128

253 9 248 251 207 208 255 192 128 128 128  175 13 224 243 193 185 249 198 255 255 128
73 17 171 221 161 179 236 167 255 234 128
1 95 247 253 212 183 255 255 128 128 128  239 90 244 250 211 209 255 255 128 128 128
155 77 195 248 188 195 255 255 128 128 128
1 24 239 251 218 219 255 205 128 128 128  201 51 219 255 196 186 128 128 128 128 128
69 46 190 239 201 218 255 228 128 128 128
1 191 251 255 255 128 128 128 128 128 128  223 165 249 255 213 255 128 128 128 128 128
141 124 248 255 255 128 128 128 128 128 128
1 16 248 255 255 128 128 128 128 128 128  190 36 230 255 236 255 128 128 128 128 128
149 1 255 128 128 128 128 128 128 128 128
1 226 255 128 128 128 128 128 128 128 128  247 192 255 128 128 128 128 128 128 128 128
240 128 255 128 128 128 128 128 128 128 128
1 134 252 255 255 128 128 128 128 128 128  213 62 250 255 255 128 128 128 128 128 128
55 93 255 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128  128 128 128 128 128 128 128 128 128 128 128
128 128 128 128 128 128 128 128 128 128 128

202 24 213 235 186 191 220 160 240 175 255  126 38 182 232 169 184 228 174 255 187 128
61 46 138 219 151 178 240 170 255 216 128
1 112 230 250 199 191 247 159 255 255 128  166 109 228 252 211 215 255 174 128 128 128
39 77 162 232 172 180 245 178 255 255 128
1 52 220 246 198 199 249 220 255 255 128  124 74 191 243 183 193 250 221 255 255 128
24 71 130 219 154 170 243 182 255 255 128
1 182 225 249 219 240 255 224 128 128 128  149 150 226 252 216 205 255 171 128 128 128
28 108 170 242 183 194 254 223 255 255 128
1 81 230 252 204 203 255 192 128 128 128  123 102 209 247 188 196 255 233 128 128 128
20 95 153 243 164 173 255 203 128 128 128
1 222 248 255 216 213 128 128 128 128 128  168 175 246 252 235 205 255 255 128 128 128
47 116 215 255 211 212 255 255 128 128 128
1 121 236 253 212 214 255 255 128 128 128  141 84 213 252 201 202 255 219 128 128 128
42 80 160 240 162 185 255 205 128 128 128
1 1 255 128 128 128 128 128 128 128 128  244 1 255 128 128 128 128 128 128 128 128
238 1 255 128 128 128 128 128 128 128 128
""")

# coeff_update_probs (RFC 6386 13.4): the probability that each entry is updated
COEF_UPDATE_PROBS = _rows("""
255 255 255 255 255 255 255 255 255 255 255  255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
176 246 255 255 255 255 255 255 255 255 255  223 241 252 255 255 255 255 255 255 255 255
249 253 253 255 255 255 255 255 255 255 255
255 244 252 255 255 255 255 255 255 255 255  234 254 254 255 255 255 255 255 255 255 255
253 255 255 255 255 255 255 255 255 255 255
255 246 254 255 255 255 255 255 255 255 255  239 253 254 255 255 255 255 255 255 255 255
254 255 254 255 255 255 255 255 255 255 255
255 248 254 255 255 255 255 255 255 255 255  251 255 254 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 253 254 255 255 255 255 255 255 255 255  251 254 254 255 255 255 255 255 255 255 255
254 255 254 255 255 255 255 255 255 255 255
255 254 253 255 254 255 255 255 255 255 255  250 255 254 255 254 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255  255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255

217 255 255 255 255 255 255 255 255 255 255  225 252 241 253 255 255 254 255 255 255 255
234 250 241 250 253 255 253 254 255 255 255
255 254 255 255 255 255 255 255 255 255 255  223 254 254 255 255 255 255 255 255 255 255
238 253 254 254 255 255 255 255 255 255 255
255 248 254 255 255 255 255 255 255 255 255  249 254 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 253 255 255 255 255 255 255 255 255 255  247 254 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 253 254 255 255 255 255 255 255 255 255  252 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 254 254 255 255 255 255 255 255 255 255  253 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 254 253 255 255 255 255 255 255 255 255  250 255 255 255 255 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255  255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255

186 251 250 255 255 255 255 255 255 255 255  234 251 244 254 255 255 255 255 255 255 255
251 251 243 253 254 255 254 255 255 255 255
255 253 254 255 255 255 255 255 255 255 255  236 253 254 255 255 255 255 255 255 255 255
251 253 253 254 254 255 255 255 255 255 255
255 254 254 255 255 255 255 255 255 255 255  254 254 254 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 254 255 255 255 255 255 255 255 255 255  254 254 255 255 255 255 255 255 255 255 255
254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255  254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255  255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255  255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255  255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255

248 255 255 255 255 255 255 255 255 255 255  250 254 252 254 255 255 255 255 255 255 255
248 254 249 253 255 255 255 255 255 255 255
255 253 253 255 255 255 255 255 255 255 255  246 253 253 255 255 255 255 255 255 255 255
252 254 251 254 254 255 255 255 255 255 255
255 254 252 255 255 255 255 255 255 255 255  248 254 253 255 255 255 255 255 255 255 255
253 255 254 254 255 255 255 255 255 255 255
255 251 254 255 255 255 255 255 255 255 255  245 251 254 255 255 255 255 255 255 255 255
253 253 254 255 255 255 255 255 255 255 255
255 251 253 255 255 255 255 255 255 255 255  252 253 254 255 255 255 255 255 255 255 255
255 254 255 255 255 255 255 255 255 255 255
255 252 255 255 255 255 255 255 255 255 255  249 255 254 255 255 255 255 255 255 255 255
255 255 254 255 255 255 255 255 255 255 255
255 255 253 255 255 255 255 255 255 255 255  250 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255  254 255 255 255 255 255 255 255 255 255 255
255 255 255 255 255 255 255 255 255 255 255
""")


# ---------------------------------------------------------- bool decoder

class BoolDecoder:
    """The boolean entropy decoder (RFC 6386 7), in libwebp's form: ``rng``
    is the range less one, ``value`` holds ``bits`` bits beyond the 8 being
    compared; a byte is loaded when they run out.  A load past the end
    reads zeros and sets ``eof`` (libwebp's test of a truncated partition,
    made after each row of modes and each macroblock's tokens)."""

    def __init__(self, data, start, end):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits, self.rng, self.eof = 0, -8, 254, 0

    def state(self):
        return self.pos, self.value, self.bits, self.rng, self.eof

    def bit(self, prob):
        if self.bits < 0:
            if self.pos < self.end:
                self.value = (self.value << 8) | self.data[self.pos]
                self.pos += 1
            else:
                self.value <<= 8
                self.eof = 1
            self.bits += 8
        split = (self.rng * prob) >> 8
        if (self.value >> self.bits) > split:
            r = self.rng - split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            r = split + 1
            bit = 0
        shift = 8 - r.bit_length()
        self.rng = (r << shift) - 1
        self.bits -= shift
        return bit

    def literal(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n):
        v = self.literal(n)
        return -v if self.bit(128) else v

    def optional_signed(self, n):
        return self.signed(n) if self.bit(128) else 0

    def tree(self, tree, probs):
        i = 0
        while True:
            i = tree[i + self.bit(probs[i >> 1])]
            if i <= 0:
                return -i


# ---------------------------------------------------------------- header

class Frame:
    """A key frame's header and what the macroblock decoder needs."""


def _clip(v, hi):
    return 0 if v < 0 else hi if v > hi else v


def parse_header(data):
    """A ``VP8 `` chunk's payload -> ``Frame``: sizes, the first
    partition's decoder after the header, the token partitions, the
    per-segment dequantization factors and filter strengths, the
    coefficient probabilities."""
    if len(data) < 10:
        raise UnsupportedWebP("a truncated VP8 frame header")
    tag = data[0] | (data[1] << 8) | (data[2] << 16)
    if tag & 1:
        raise UnsupportedWebP("a VP8 interframe (WebP holds one key frame)")
    if (tag >> 1) & 7 > 3:
        raise UnsupportedWebP(f"a VP8 frame of profile {(tag >> 1) & 7}")
    if not (tag >> 4) & 1:
        raise UnsupportedWebP("a VP8 frame that is not shown")
    part0_size = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise UnsupportedWebP("a VP8 key frame without its start code")
    w, h = struct.unpack_from("<HH", data, 6)
    f = Frame()
    f.width, f.height = w & 0x3FFF, h & 0x3FFF
    if f.width == 0 or f.height == 0:
        raise UnsupportedWebP("a VP8 frame of no pixels")
    f.mb_w, f.mb_h = (f.width + 15) >> 4, (f.height + 15) >> 4
    if 10 + part0_size > len(data):
        raise UnsupportedWebP("a truncated VP8 first partition")
    br = BoolDecoder(data, 10, 10 + part0_size)
    br.bit(128)  # colour space
    br.bit(128)  # clamping type: libwebp always clamps
    use_segment = br.bit(128)
    f.update_map, absolute = 0, 0
    quantizer, filter_strength = [0] * 4, [0] * 4
    f.segment_probs = [255, 255, 255]
    if use_segment:
        f.update_map = br.bit(128)
        if br.bit(128):  # update the segments' data
            absolute = br.bit(128)
            quantizer = [br.optional_signed(7) for _ in range(4)]
            filter_strength = [br.optional_signed(6) for _ in range(4)]
        if f.update_map:
            f.segment_probs = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    simple = br.bit(128)
    level = br.literal(6)
    sharpness = br.literal(3)
    use_lf_delta = br.bit(128)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    if use_lf_delta and br.bit(128):
        ref_delta = [br.optional_signed(6) for _ in range(4)]
        mode_delta = [br.optional_signed(6) for _ in range(4)]
    f.n_parts = 1 << br.literal(2)
    # the token partitions: their sizes (3 bytes each but the last's) follow
    # the first partition
    sizes_at = 10 + part0_size
    part_start = sizes_at + 3 * (f.n_parts - 1)
    if part_start > len(data):
        raise UnsupportedWebP("a truncated VP8 partition table")
    f.parts = []
    for p in range(f.n_parts):
        if p < f.n_parts - 1:
            size = int.from_bytes(data[sizes_at + 3 * p:sizes_at + 3 * p + 3], "little")
            end = min(part_start + size, len(data))
        else:
            end = len(data)
        f.parts.append((part_start, end))
        part_start = end
    if f.parts[-1][0] >= len(data):
        raise UnsupportedWebP("a truncated VP8 token partition")
    # quantizer indices -> per-segment dequantization factors (libwebp's)
    base_q = br.literal(7)
    dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (br.optional_signed(4) for _ in range(5))
    f.dequant = np.zeros((4, 6), np.int32)
    for s in range(4):
        q = (quantizer[s] + (0 if absolute else base_q)) if use_segment else base_q
        y2_ac = (AC_TABLE[_clip(q + dy2_ac, 127)] * 101581) >> 16
        f.dequant[s] = (DC_TABLE[_clip(q + dy1_dc, 127)], AC_TABLE[_clip(q, 127)],
                        DC_TABLE[_clip(q + dy2_dc, 127)] * 2, max(y2_ac, 8),
                        DC_TABLE[_clip(q + duv_dc, 117)], AC_TABLE[_clip(q + duv_ac, 127)])
    br.bit(128)  # refresh entropy probabilities: one frame, no effect
    f.coef_probs = DEFAULT_COEF_PROBS.copy()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for n in range(11):
                    if br.bit(int(COEF_UPDATE_PROBS[t, b, c, n])):
                        f.coef_probs[t, b, c, n] = br.literal(8)
    f.use_skip = br.bit(128)
    f.skip_prob = br.literal(8) if f.use_skip else 0
    # the loop filter: 0 none, 1 simple, 2 normal; per segment and 4x4-ness
    # (limit, interior limit, hev threshold, inner edges), as libwebp
    # precomputes them
    f.filter_type = 0 if level == 0 else 1 if simple else 2
    f.filters = np.zeros((4, 2, 4), np.int32)
    for s in range(4):
        base = level
        if use_segment:
            base = filter_strength[s] + (0 if absolute else level)
        for i4x4 in range(2):
            lvl = base
            if use_lf_delta:
                lvl += ref_delta[0] + (mode_delta[0] if i4x4 else 0)
            lvl = _clip(lvl, 63)
            if lvl > 0:
                ilevel = lvl
                if sharpness > 0:
                    ilevel >>= 2 if sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - sharpness)
                ilevel = max(ilevel, 1)
                f.filters[s, i4x4] = (2 * lvl + ilevel, ilevel,
                                      2 if lvl >= 40 else 1 if lvl >= 15 else 0, i4x4)
            else:
                f.filters[s, i4x4] = (0, 0, 0, i4x4)
    if br.eof:
        raise UnsupportedWebP("a truncated VP8 frame header")
    f.br = br
    f.data = data
    return f


# ------------------------------------------------------------ macroblocks

def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def predict4(mode, top, left):
    """A 4x4 block's prediction: ``top`` is [top-left, 8 above (4 and the 4
    above-right)], ``left`` the 4 pixels to the left -> 4 rows of 4."""
    X, A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    if mode == B_DC_PRED:
        dc = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[dc] * 4 for _ in range(4)]
    if mode == B_TM_PRED:
        return [[min(255, max(0, left[y] + t - X)) for t in (A, B, C, D)] for y in range(4)]
    if mode == B_VE_PRED:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row[:] for _ in range(4)]
    if mode == B_HE_PRED:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                                  _avg3(K, L, L))]
    p = [[0] * 4 for _ in range(4)]

    def put(v, *xy):
        for x, y in xy:
            p[y][x] = v

    if mode == B_LD_PRED:
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == B_RD_PRED:
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(X, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, X, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, X), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == B_VR_PRED:
        put(_avg2(X, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, X), (0, 2))
        put(_avg3(I, X, A), (0, 1), (1, 3))
        put(_avg3(X, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == B_VL_PRED:
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == B_HD_PRED:
        put(_avg2(I, X), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(X, A, B), (2, 0))
        put(_avg3(I, X, A), (1, 0), (3, 1))
        put(_avg3(J, I, X), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    else:  # B_HU_PRED
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    return p


def predict_block(mode, size, top, left, top_left, mb_x, mb_y):
    """A 16x16 luma or 8x8 chroma prediction; DC uses only the edges that
    exist inside the frame (libwebp's CheckMode)."""
    if mode == DC_PRED:
        shift = 4 if size == 16 else 3
        if mb_x > 0 and mb_y > 0:
            dc = (sum(top) + sum(left) + size) >> (shift + 1)
        elif mb_y > 0:
            dc = (sum(top) + (size >> 1)) >> shift
        elif mb_x > 0:
            dc = (sum(left) + (size >> 1)) >> shift
        else:
            dc = 128
        return [[dc] * size for _ in range(size)]
    if mode == V_PRED:
        return [list(top) for _ in range(size)]
    if mode == H_PRED:
        return [[v] * size for v in left]
    return [[min(255, max(0, lv + t - top_left)) for t in top] for lv in left]  # TM_PRED


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def idct_add(coefs, block):
    """The inverse DCT of 16 coefficients added to the 4x4 ``block`` (rows
    of pixels, changed in place), clamped."""
    tmp = [0] * 16
    for i in range(4):
        a = coefs[i] + coefs[8 + i]
        b = coefs[i] - coefs[8 + i]
        c = _mul2(coefs[4 + i]) - _mul1(coefs[12 + i])
        d = _mul1(coefs[4 + i]) + _mul2(coefs[12 + i])
        tmp[4 * i:4 * i + 4] = (a + d, b + c, b - c, a - d)
    for i in range(4):
        dc = tmp[i] + 4
        a = dc + tmp[8 + i]
        b = dc - tmp[8 + i]
        c = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        row = block[i]
        for x, v in enumerate((a + d, b + c, b - c, a - d)):
            row[x] = min(255, max(0, row[x] + (v >> 3)))


def iwht(coefs):
    """The inverse Walsh-Hadamard transform of the Y2 block -> the 16 luma
    blocks' DC coefficients in raster order."""
    tmp = [0] * 16
    for i in range(4):
        a0 = coefs[i] + coefs[12 + i]
        a1 = coefs[4 + i] + coefs[8 + i]
        a2 = coefs[4 + i] - coefs[8 + i]
        a3 = coefs[i] - coefs[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = tmp[4 * i] + 3
        a0 = dc + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = dc - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = ((a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3)
    return out


def _int16(v):
    return ((v + 32768) & 0xFFFF) - 32768


def read_coefs(br, probs, ctx, dq, first, out):
    """One block's tokens (libwebp's GetCoeffs): dequantized coefficients
    into ``out`` (16, zigzag order undone); returns the position after the
    last token read (its context flag is ``> first``)."""
    n = first
    p = probs[BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n  # end of block
        while not br.bit(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = probs[BANDS[n]][0]
        if not br.bit(p[2]):
            v, nxt = 1, 1
        else:
            if not br.bit(p[3]):
                v = 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
            elif not br.bit(p[6]):
                if not br.bit(p[7]):
                    v = 5 + br.bit(159)
                else:
                    v = 7 + 2 * br.bit(165)
                    v += br.bit(145)
            else:
                bit1 = br.bit(p[8])
                bit0 = br.bit(p[9 + bit1])
                cat = 2 * bit1 + bit0
                v = 0
                for prob in CAT_PROBS[cat]:
                    v = 2 * v + br.bit(prob)
                v += 3 + (8 << cat)
            nxt = 2
        if br.bit(128):
            v = -v
        out[ZIGZAG[n]] = _int16(v * dq[n > 0])
        n += 1
        p = probs[BANDS[n]][nxt]
    return 16


def _parse_modes(br, f, mb_x, top_modes, left_modes):
    """One macroblock's header from the first partition: (segment, skip,
    y mode, 16 sub-block modes or None, uv mode)."""
    segment = 0
    if f.update_map:
        segment = br.tree(SEGMENT_TREE, f.segment_probs)
    skip = br.bit(f.skip_prob) if f.use_skip else 0
    ymode = br.tree(KF_YMODE_TREE, KF_YMODE_PROB)
    bmodes = None
    top = top_modes[4 * mb_x:4 * mb_x + 4]
    if ymode == B_PRED:
        bmodes = [0] * 16
        for y in range(4):
            left = left_modes[y]
            for x in range(4):
                m = br.tree(BMODE_TREE, KF_BMODE_PROBS[top[x]][left])
                bmodes[4 * y + x] = m
                top[x] = left = m
            left_modes[y] = left
    else:
        implied = IMPLIED_BMODE[ymode]
        top = [implied] * 4
        left_modes[:] = [implied] * 4
    top_modes[4 * mb_x:4 * mb_x + 4] = top
    uvmode = br.tree(UV_MODE_TREE, KF_UV_MODE_PROB)
    return segment, skip, ymode, bmodes, uvmode


def _parse_residuals(br, f, segment, is_i4x4, nz_top, nz_left, nz_dc, mb_x):
    """One macroblock's 25 blocks of tokens: (coefficients (25, 16), whether
    any is non-zero as libwebp's filter reads it)."""
    dq = f.dequant[segment]
    probs = f.probs_list
    coefs = [[0] * 16 for _ in range(25)]
    nonzero = False
    if not is_i4x4:
        ctx = nz_dc[0][mb_x] + nz_dc[1]
        nz = read_coefs(br, probs[1], ctx, (dq[2], dq[3]), 0, coefs[24])
        nz_dc[0][mb_x] = nz_dc[1] = int(nz > 0)
        dcs = iwht(coefs[24])
        for i in range(16):
            coefs[i][0] = _int16(dcs[i])
        first, yprobs = 1, probs[0]
    else:
        first, yprobs = 0, probs[3]
    top = nz_top[mb_x]
    for y in range(4):
        left = nz_left[y]
        for x in range(4):
            b = 4 * y + x
            nz = read_coefs(br, yprobs, left + top[x], (dq[0], dq[1]), first, coefs[b])
            left = top[x] = int(nz > first)
            nonzero |= nz > 1 or coefs[b][0] != 0
        nz_left[y] = left
    for ch in range(2):
        for y in range(2):
            left = nz_left[4 + 2 * ch + y]
            for x in range(2):
                b = 16 + 4 * ch + 2 * y + x
                nz = read_coefs(br, probs[2], left + top[4 + 2 * ch + x], (dq[4], dq[5]), 0,
                                coefs[b])
                left = top[4 + 2 * ch + x] = int(nz > 0)
                nonzero |= nz > 1 or coefs[b][0] != 0
            nz_left[4 + 2 * ch + y] = left
    return coefs, nonzero


def decode_macroblocks_py(f):
    """Every macroblock of frame ``f`` -> the (Y, U, V) planes, macroblock
    aligned, loop-filtered."""
    f.probs_list = f.coef_probs.tolist()
    W, H = 16 * f.mb_w, 16 * f.mb_h
    planes = [np.zeros((H, W), np.int32), np.zeros((H // 2, W // 2), np.int32),
              np.zeros((H // 2, W // 2), np.int32)]
    ys, us, vs = (p.tolist() for p in planes)
    top_modes = [B_DC_PRED] * (4 * f.mb_w)
    nz_top = [[0] * 8 for _ in range(f.mb_w)]  # 4 luma, 2 u, 2 v
    nz_dc = [[0] * f.mb_w, 0]
    infos = []
    parts = [BoolDecoder(f.data, s, e) for s, e in f.parts]
    br = f.br
    for mb_y in range(f.mb_h):
        left_modes = [B_DC_PRED] * 4
        nz_left = [0] * 8
        nz_dc[1] = 0
        tokens = parts[mb_y % f.n_parts]
        row_modes = [_parse_modes(br, f, mb_x, top_modes, left_modes) for mb_x in range(f.mb_w)]
        if br.eof:
            raise UnsupportedWebP(TRUNCATED)
        for mb_x in range(f.mb_w):
            segment, skip, ymode, bmodes, uvmode = row_modes[mb_x]
            is_i4x4 = ymode == B_PRED
            if not skip:
                coefs, nonzero = _parse_residuals(tokens, f, segment, is_i4x4, nz_top, nz_left,
                                                  nz_dc, mb_x)
                skip = not nonzero
            else:
                coefs = None
                nz_top[mb_x] = [0] * 8
                nz_left[:] = [0] * 8
                if not is_i4x4:
                    nz_dc[0][mb_x] = nz_dc[1] = 0
            if tokens.eof:
                raise UnsupportedWebP(TRUNCATED)
            limit, ilevel, hev, inner = (int(v) for v in f.filters[segment, int(is_i4x4)])
            infos.append((limit, ilevel, hev, inner or not skip))
            _reconstruct(ys, us, vs, mb_x, mb_y, f.mb_w, ymode, bmodes, uvmode, coefs)
    if f.filter_type:
        _loop_filter(ys, us, vs, f, infos)
    return tuple(np.array(p, np.uint8) for p in (ys, us, vs))


def _edges(plane, x0, y0, size, extra):
    """A macroblock's top row (with ``extra`` pixels above-right), left
    column and top-left pixel from the unfiltered ``plane``, with the
    frame's edges: 127 above the first row, 129 left of the first column."""
    if y0 == 0:
        top = [127] * (size + extra)
        top_left = 127
    else:
        row = plane[y0 - 1]
        top = row[x0:x0 + size]
        if extra:
            if x0 + size < len(row):
                top = top + row[x0 + size:x0 + size + extra]
            else:
                top = top + [row[x0 + size - 1]] * extra
        top_left = 129 if x0 == 0 else row[x0 - 1]
    left = [129] * size if x0 == 0 else [plane[y0 + j][x0 - 1] for j in range(size)]
    return top, left, top_left


def _reconstruct(ys, us, vs, mb_x, mb_y, mb_w, ymode, bmodes, uvmode, coefs):
    x0, y0 = 16 * mb_x, 16 * mb_y
    top, left, top_left = _edges(ys, x0, y0, 16, 4)
    if bmodes is not None:
        # a work area of the macroblock with its edges: row 0 above, column 0
        # to the left; the above-right pixels repeat at rows 4, 8 and 12
        work = [[top_left] + top] + [[left[j]] + [0] * 20 for j in range(16)]
        for r in (4, 8, 12):
            work[r][17:21] = top[16:20]
        for n in range(16):
            by, bx = 4 * (n >> 2), 4 * (n & 3)
            above = work[by][bx:bx + 9]
            side = [work[by + 1 + j][bx] for j in range(4)]
            block = predict4(bmodes[n], above, side)
            if coefs is not None:
                idct_add(coefs[n], block)
            for j in range(4):
                work[by + 1 + j][bx + 1:bx + 5] = block[j]
        for j in range(16):
            ys[y0 + j][x0:x0 + 16] = work[j + 1][1:17]
    else:
        pred = predict_block(ymode, 16, top[:16], left, top_left, mb_x, mb_y)
        if coefs is not None:
            for n in range(16):
                by, bx = 4 * (n >> 2), 4 * (n & 3)
                block = [pred[by + j][bx:bx + 4] for j in range(4)]
                idct_add(coefs[n], block)
                for j in range(4):
                    pred[by + j][bx:bx + 4] = block[j]
        for j in range(16):
            ys[y0 + j][x0:x0 + 16] = pred[j]
    for ch, plane in enumerate((us, vs)):
        cx0, cy0 = 8 * mb_x, 8 * mb_y
        top, left, top_left = _edges(plane, cx0, cy0, 8, 0)
        pred = predict_block(uvmode, 8, top, left, top_left, mb_x, mb_y)
        if coefs is not None:
            for n in range(4):
                by, bx = 4 * (n >> 1), 4 * (n & 1)
                block = [pred[by + j][bx:bx + 4] for j in range(4)]
                idct_add(coefs[16 + 4 * ch + n], block)
                for j in range(4):
                    pred[by + j][bx:bx + 4] = block[j]
        for j in range(8):
            plane[cy0 + j][cx0:cx0 + 8] = pred[j]


# ------------------------------------------------------------ loop filter

def _sclip1(v):  # [-1020, 1020] -> [-128, 127]
    return -128 if v < -128 else 127 if v > 127 else v


def _sclip2(v):  # [-112, 112] -> [-16, 15]
    return -16 if v < -16 else 15 if v > 15 else v


def _clip1(v):
    return 0 if v < 0 else 255 if v > 255 else v


def _filter2(px, i, s):
    p1, p0, q0, q1 = px[i - 2 * s], px[i - s], px[i], px[i + s]
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    px[i - s] = _clip1(p0 + a2)
    px[i] = _clip1(q0 - a1)


def _filter4(px, i, s):
    p1, p0, q0, q1 = px[i - 2 * s], px[i - s], px[i], px[i + s]
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    px[i - 2 * s] = _clip1(p1 + a3)
    px[i - s] = _clip1(p0 + a2)
    px[i] = _clip1(q0 - a1)
    px[i + s] = _clip1(q1 - a3)


def _filter6(px, i, s):
    p2, p1, p0 = px[i - 3 * s], px[i - 2 * s], px[i - s]
    q0, q1, q2 = px[i], px[i + s], px[i + 2 * s]
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    px[i - 3 * s] = _clip1(p2 + a3)
    px[i - 2 * s] = _clip1(p1 + a2)
    px[i - s] = _clip1(p0 + a1)
    px[i] = _clip1(q0 - a1)
    px[i + s] = _clip1(q1 - a2)
    px[i + 2 * s] = _clip1(q2 - a3)


def _needs_filter(px, i, s, t):
    return 4 * abs(px[i - s] - px[i]) + abs(px[i - 2 * s] - px[i + s]) <= t


def _needs_filter2(px, i, s, t, it):
    p3, p2, p1, p0 = px[i - 4 * s], px[i - 3 * s], px[i - 2 * s], px[i - s]
    q0, q1, q2, q3 = px[i], px[i + s], px[i + 2 * s], px[i + 3 * s]
    if 4 * abs(p0 - q0) + abs(p1 - q1) > t:
        return False
    return (abs(p3 - p2) <= it and abs(p2 - p1) <= it and abs(p1 - p0) <= it
            and abs(q3 - q2) <= it and abs(q2 - q1) <= it and abs(q1 - q0) <= it)


def _hev(px, i, s, t):
    return abs(px[i - 2 * s] - px[i - s]) > t or abs(px[i + s] - px[i]) > t


def _simple_edge(px, start, s, step, n, thresh):
    t = 2 * thresh + 1
    for k in range(n):
        i = start + k * step
        if _needs_filter(px, i, s, t):
            _filter2(px, i, s)


def _normal_edge(px, start, s, step, n, thresh, ithresh, hev_t, mb_edge):
    t = 2 * thresh + 1
    for k in range(n):
        i = start + k * step
        if _needs_filter2(px, i, s, t, ithresh):
            if _hev(px, i, s, hev_t):
                _filter2(px, i, s)
            elif mb_edge:
                _filter6(px, i, s)
            else:
                _filter4(px, i, s)


def _loop_filter(ys, us, vs, f, infos):
    """libwebp's DoFilter on every macroblock in raster order: the left
    edge, the inner vertical edges, the top edge, the inner horizontal
    edges (luma; with the normal filter, chroma too)."""
    planes = []
    for p in (ys, us, vs):
        planes.append(([v for row in p for v in row], len(p[0])))
    (Y, yw), (U, uw), (V, vw) = planes
    for n, (limit, ilevel, hev_t, inner) in enumerate(infos):
        if limit == 0:
            continue
        mb_y, mb_x = divmod(n, f.mb_w)
        yi = 16 * mb_y * yw + 16 * mb_x
        ci = 8 * mb_y * uw + 8 * mb_x
        if f.filter_type == 1:
            if mb_x > 0:
                _simple_edge(Y, yi, 1, yw, 16, limit + 4)
            if inner:
                for k in (4, 8, 12):
                    _simple_edge(Y, yi + k, 1, yw, 16, limit)
            if mb_y > 0:
                _simple_edge(Y, yi, yw, 1, 16, limit + 4)
            if inner:
                for k in (4, 8, 12):
                    _simple_edge(Y, yi + k * yw, yw, 1, 16, limit)
            continue
        if mb_x > 0:
            _normal_edge(Y, yi, 1, yw, 16, limit + 4, ilevel, hev_t, True)
            for C in (U, V):
                _normal_edge(C, ci, 1, uw, 8, limit + 4, ilevel, hev_t, True)
        if inner:
            for k in (4, 8, 12):
                _normal_edge(Y, yi + k, 1, yw, 16, limit, ilevel, hev_t, False)
            for C in (U, V):
                _normal_edge(C, ci + 4, 1, uw, 8, limit, ilevel, hev_t, False)
        if mb_y > 0:
            _normal_edge(Y, yi, yw, 1, 16, limit + 4, ilevel, hev_t, True)
            for C in (U, V):
                _normal_edge(C, ci, uw, 1, 8, limit + 4, ilevel, hev_t, True)
        if inner:
            for k in (4, 8, 12):
                _normal_edge(Y, yi + k * yw, yw, 1, 16, limit, ilevel, hev_t, False)
            for C in (U, V):
                _normal_edge(C, ci + 4 * uw, uw, 1, 8, limit, ilevel, hev_t, False)
    for (flat, width), rows in zip(((Y, yw), (U, uw), (V, vw)), (ys, us, vs)):
        for j in range(len(rows)):
            rows[j][:] = flat[j * width:(j + 1) * width]


# ----------------------------------------------------------------- native

def decode_macroblocks_native(f):
    """``decode_macroblocks_py`` in C++ (``csrc/webp_host.cc``)."""
    from .. import kernels

    lib = kernels.host_library("webp_host")
    W, H = 16 * f.mb_w, 16 * f.mb_h
    y = np.empty((H, W), np.uint8)
    u = np.empty((H // 2, W // 2), np.uint8)
    v = np.empty((H // 2, W // 2), np.uint8)
    data = np.frombuffer(f.data, np.uint8)
    pos, value, bits, rng, eof = f.br.state()
    parts = np.array(f.parts, np.int64).reshape(-1)
    params = np.array([f.mb_w, f.mb_h, f.update_map, *f.segment_probs, f.use_skip,
                       f.skip_prob, f.filter_type, f.n_parts], np.int32)
    state = np.array([pos, f.br.end, value, bits, rng, eof], np.int64)
    coef_probs = np.ascontiguousarray(f.coef_probs, np.uint8)
    bmode_probs = np.array(KF_BMODE_PROBS, np.uint8)
    dequant = np.ascontiguousarray(f.dequant, np.int32)
    filters = np.ascontiguousarray(f.filters, np.int32)
    err = lib.omw_vp8_decode(data.ctypes.data, len(data), state.ctypes.data, parts.ctypes.data,
                             params.ctypes.data, coef_probs.ctypes.data,
                             bmode_probs.ctypes.data, dequant.ctypes.data, filters.ctypes.data,
                             y.ctypes.data, u.ctypes.data, v.ctypes.data)
    if err == 1:
        raise UnsupportedWebP(TRUNCATED)
    if err:
        raise MemoryError("omw_vp8_decode")
    return y, u, v


# ------------------------------------------------------------ YUV -> RGB

def decode_yuv(data, macroblocks=None):
    """A ``VP8 `` payload -> its Y (H, W), U and V ((H+1)//2, (W+1)//2)
    planes, as ``WebPDecodeYUV`` gives them."""
    f = parse_header(data)
    y, u, v = (macroblocks or decode_macroblocks_native)(f)
    ch, cw = (f.height + 1) // 2, (f.width + 1) // 2
    return y[:f.height, :f.width].copy(), u[:ch, :cw].copy(), v[:ch, :cw].copy()


def _upsample_rows(t, c):
    """libwebp's fancy upsampler along a row pair: chroma rows ``t`` (the
    nearer one) and ``c`` (n,) -> the 2n samples of the output row next to
    ``t`` (the caller crops to the luma width)."""
    t = t.astype(np.int32)
    c = c.astype(np.int32)
    n = len(t)
    out = np.empty(2 * n, np.int32)
    out[0] = (3 * t[0] + c[0] + 2) >> 2
    if n > 1:
        tl, tt, ll, cc = t[:-1], t[1:], c[:-1], c[1:]
        avg = tl + tt + ll + cc + 8
        diag_12 = (avg + 2 * (tt + ll)) >> 3
        diag_03 = (avg + 2 * (tl + cc)) >> 3
        out[1:2 * n - 1:2] = (diag_12 + tl) >> 1
        out[2:2 * n - 1:2] = (diag_03 + tt) >> 1
    out[2 * n - 1] = (3 * t[-1] + c[-1] + 2) >> 2
    return out


def upsample(plane, height, width):
    """A chroma plane ((H+1)//2, (W+1)//2) -> (H, W) by libwebp's fancy
    upsampler (``UpsampleRgbLinePair`` in ``EmitFancyRGB``): row 0 from
    chroma row 0; rows 2k-1 and 2k from rows k-1 and k; the last row of an
    even height from the last chroma row."""
    out = np.empty((height, width), np.int32)
    out[0] = _upsample_rows(plane[0], plane[0])[:width]
    for k in range(1, (height + 1) // 2 + 1):
        top, cur = plane[k - 1], plane[min(k, len(plane) - 1)]
        if 2 * k - 1 < height:
            out[2 * k - 1] = _upsample_rows(top, cur)[:width]
        if 2 * k < height:
            out[2 * k] = _upsample_rows(cur, top)[:width]
    return out


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y, u, v):
    """libwebp's 14-bit fixed-point YUV->RGB (``VP8YUVToR/G/B``) after the
    fancy upsampling of ``u`` and ``v`` -> (H, W, 3) uint8."""
    height, width = y.shape
    y = y.astype(np.int32)
    uu = upsample(u, height, width)
    vv = upsample(v, height, width)
    r = _clip8(_mult_hi(y, 19077) + _mult_hi(vv, 26149) - 14234)
    g = _clip8(_mult_hi(y, 19077) - _mult_hi(uu, 6419) - _mult_hi(vv, 13320) + 8708)
    b = _clip8(_mult_hi(y, 19077) + _mult_hi(uu, 33050) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def decode_rgb(data, macroblocks=None):
    """A ``VP8 `` payload -> (H, W, 3) uint8 RGB, as cv2 reads it."""
    return yuv_to_rgb(*decode_yuv(data, macroblocks))
