"""Host-to-device pipelining (counterpart of ``afford_motion_tpu/parallel``);
one device for now: the mesh, its shardings and the multi-device helpers are
not ported yet."""
