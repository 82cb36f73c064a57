# The PyTorch/CUDA port's test CLI (python -m ryolo_tpu_torch.test; add
# --device cpu to run on the CPU)
python -m ryolo_tpu_torch.test --data configs/UCAS_AOD.yaml --hyp configs/hyp.yaml --weight_path weights/basekf/best.pth --batch_size 8 --img_size 608
