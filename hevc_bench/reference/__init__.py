"""The benchmark's plain reference: an HEVC decoder in NumPy for the Main
profile subset that HomerHEVC writes (ITU-T H.265 sections 7 to 9): one
slice per picture, I and P slices with one reference picture, 2Nx2N and
intra NxN partitions, merge and AMVP without temporal candidates, the
residual quadtree with sign hiding and cu_qp_delta, WPP substreams,
deblocking and SAO.

It is written from the specification and imports neither JAX, the JAX
package nor anything of homerhevc_tpu_torch; the CABAC initialisation
values and the transform's coefficients are the normative tables.
"""
