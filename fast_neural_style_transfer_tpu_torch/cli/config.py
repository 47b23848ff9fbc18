"""Defaults of the CLIs, with the same names and values as the JAX
package's ``cli/config.py``."""

training_config = {
    "TOTAL_STEPS": 80_000,
    "BATCH_SIZE": 20,
    "LEARNING_RATE": 1e-3,
    "NUM_EPOCHS": 4,  # accepted for flag parity; the loop is step-bounded
    "TRAIN_IMAGE_SHAPE": (256, 256),
}

# style and content weights change every 10k iterations (train/schedule.py)
loss_weights_config = {
    "CONTENT_WEIGHT": 1000.0,
    "STYLE_WEIGHT": 1.0,
    "TV_WEIGHT": 10.0,
}

vgg_loss_layers = {
    "CONTENT_LAYER": "relu4_2",
    "STYLE_LAYERS": ("relu1_2", "relu2_2", "relu3_3"),
    "STYLE_LAYER_WEIGHTS": (0.25, 0.3, 0.45),
}

style_image = "style.jpg"
training_monitor_content_image = "dancing.jpg"
dataset_dir = "data/train"
output_dir = "training_output"
inference_content_image = "dancing.jpg"
vgg19_weights = None  # or a path to .npz / torchvision .pth (models/vgg_weights.py)
