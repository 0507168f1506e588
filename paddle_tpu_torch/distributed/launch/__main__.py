from paddle_tpu_torch.distributed.launch.main import main

if __name__ == "__main__":
    main()
