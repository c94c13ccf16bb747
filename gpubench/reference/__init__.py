"""The plain reference of the benchmark: NumPy and plain PyTorch, with no
import of the program or of JAX.

A configuration names the class that judges it by its "reference_class",
"<module>.<Class>" of gpubench/reference/<module>.py ("model.DriftReference"
where the key is absent; harness.reference_class resolves it). What
harness.run_cell, calibrate.py, check.sample_indices and check.readings
read of such a class:

    Class(sections, device)  built from the parameter sections of the
                             cell's simulations (harness.cell_sections) on
                             a torch device
    bl                       (nbl, 3) float64 baseline vectors, in the
                             program's order
    nbl, nchan, n_acc        the cube's sizes (B, C, T)
    visibilities(lst_init, t, bl, ch, precision="float64")
                             (len(t), len(bl), len(ch)) complex sky
                             visibilities of the simulation that starts at
                             LST lst_init (hours), at those accumulations,
                             baselines and channels
    uvw(lst_init, precision) (nbl, 3, n_acc) projected baselines
    vis_rms(precision)       (nchan,) noise rms of a visibility in Jy
    schedule(lst_init)       (lst_deg (n_acc,), jd (n_acc,))
    precisions               the precisions it computes: "float64" (the
                             reference), and where it offers them
                             "control" and "phase32"; calibrate.py reports
                             those it lacks as not computed

The precisions below "float64" are used by calibrate.py alone. Some
per-layer readers read more of it in the cells that list them:
`live_counts(lst_init)` and `nsrc` (k1a_roofline, k2_roofline,
amps_roofline, spread_roofline).
reference/products.py reads a product written to disk back into the sample
that check.readings compares.
"""
