from fast_neural_style_transfer_tpu_torch.parallel.mesh import (
    DataAxis,
    MeshAxis,
    MeshPlan,
    ReplicaPlan,
    SpaceAxis,
    choose_backend,
    launch,
    make_mesh_plan,
    place_on_data_axis,
)

__all__ = ["DataAxis", "MeshAxis", "MeshPlan", "ReplicaPlan", "SpaceAxis",
           "choose_backend", "launch", "make_mesh_plan", "place_on_data_axis"]
