"""The share of the window's lanes whose result meets the constraint
(opt_constr below the configuration's ``feasible_below``) and is finite,
counted on the device and read once after the window."""


def read(rec):
    return rec["feasible"] / rec["lanes"]
