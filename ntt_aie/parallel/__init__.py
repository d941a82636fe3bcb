from ntt_aie.parallel import fourstep, mesh
