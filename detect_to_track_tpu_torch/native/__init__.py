"""native (C++) host-side code, built with g++ at first use into `build/native/`
and loaded with ctypes: the multi-path Viterbi linker (viterbi_native)."""
