"""Operators of the port: the kernel modules, named after the TPU kernels
they replace -- K1 ``pallas_fuse_warp``, K2 ``pallas_pool``, K3
``pallas_sample``, K5 ``pallas_warp``, K6 ``pallas_conv3d``, K7
``pallas_conv``, K8 ``pallas_occ_tail``, K9 ``pallas_occ_fuse``, K10
``pallas_deform`` -- and the kernel-free differentiable helpers."""
