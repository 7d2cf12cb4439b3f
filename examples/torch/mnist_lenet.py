"""LeNet-5 on MNIST through the sequential builder API (the port's twin
of examples/mnist_lenet.py). Runs on the card; `--device cpu` runs it
on the CPU."""
import argparse
import os
import tempfile

from deeplearning4j_tpu_torch.datasets.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.models.lenet import lenet5
from deeplearning4j_tpu_torch.optimize.listeners import ScoreIterationListener
from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default=None, help="cuda (default) or cpu")
args = ap.parse_args()

train = MnistDataSetIterator(batch_size=128, num_examples=2048,
                             reshape_images=True, shuffle=True)
test = MnistDataSetIterator(batch_size=256, num_examples=512, train=False,
                            reshape_images=True)

net = lenet5(learning_rate=2e-3, device=args.device)
net.init()
net.set_listeners(ScoreIterationListener(print_iterations=16, printer=print))

# whole-epoch training: the batches staged on the device, no loss read
# back until the epoch ends
net.fit_scanned(train, epochs=4)
print("epoch losses:", [round(float(x), 4) for x in net._epoch_losses])

ev = net.evaluate(test)
print(ev.stats())

path = os.path.join(tempfile.gettempdir(), "lenet.zip")
ModelSerializer.write_model(net, path)
restored = ModelSerializer.restore_multi_layer_network(path,
                                                       device=args.device)
test.reset()
print("restored accuracy:", restored.evaluate(test).accuracy())
