"""fit_a_line's entries: the local trainer (`train_local`) and the
elastic one (`train_elastic`)."""
