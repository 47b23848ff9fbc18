from fast_neural_style_transfer_tpu_torch.parallel.mesh import (
    MeshPlan,
    SpaceAxis,
    choose_backend,
    launch,
    make_mesh_plan,
)

__all__ = ["MeshPlan", "SpaceAxis", "choose_backend", "launch", "make_mesh_plan"]
