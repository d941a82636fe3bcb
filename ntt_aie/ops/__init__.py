from ntt_aie.ops import modops
