"""The preemption drills of the port's trainers (``soak``, ``adain_soak``)."""
