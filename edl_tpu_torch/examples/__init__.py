"""The training entries of the port: ``python -m
edl_tpu_torch.examples.<name>.train``, the command a pod's ``EDL_ENTRY``
names and the launcher execs (and relaunches after a rescale exit).
Importing a module here runs nothing."""
