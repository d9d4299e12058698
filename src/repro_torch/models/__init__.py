"""Models: transformer layers and the LMs (training forward, decode), and
the paper's CNNs (SimpleCNN, LeNet5, VGG11, ResNet18-GN)."""
